"""AdamW with float32 state over (possibly bfloat16) params, the port of
``repro.optim.adamw``.

The state mirrors the parameter tree (nested dicts and lists of tensors,
walked with :func:`repro_torch.models.common.tree_map`).  :meth:`AdamW.update`
is the reference's arithmetic, operation for operation: float32 moments,
the global norm over the leaves in the reference's order (dict keys
sorted), clipping at ``grad_clip``, bias correction, decoupled weight decay
on leaves with ``ndim >= 2`` only, float32 updates.  Nothing in it reads a
value back to the host: ``step`` stays a tensor on the parameters' device.
Where XLA's float32 operations are correctly rounded (sqrt, division, the
products), the updates equal the reference's bit for bit; ``b ** step``
and a cosine learning rate are not correctly rounded in either package,
and a clipped step's global norm sums in another order, so those can
differ from the reference's in the last bit.

:meth:`AdamW.apply` is the same step applied leaf by leaf for the trainer:
each leaf's float32 update lives only until its parameter is updated, and
the moments are written in place, so a full-width model holds one leaf's
temporaries at a time and never a second copy of the state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's and the card's are; torch's
    CPU float32 sqrt (a vector body) is not, so the CPU takes it in
    float64, whose rounding to float32 is exact for a square root."""
    return torch.sqrt(x.double()).float() if x.device.type == "cpu" else torch.sqrt(x)


@dataclasses.dataclass
class AdamWState:
    """Fields in the reference's order (a checkpoint stores them so)."""

    step: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Any) -> AdamWState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(zeros, params),
            v=tree_map(zeros, params),
        )

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=step.device)

    def global_norm(self, grads: Any) -> torch.Tensor:
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads)]
        return _sqrt(sum(sq))

    def _prepare(self, grads: Any, state: AdamWState):
        """The step's scalars: (step, lr, clip scale, both bias corrections)."""
        step = state.step + 1
        lr = self._lr(step)
        gnorm = self.global_norm(grads)
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        s = step.to(torch.float32)
        return step, lr, scale, 1 - self.b1**s, 1 - self.b2**s

    def _leaf(self, g, m, v, p, lr, scale, bc1, bc2):
        """One leaf's (f32 update, new m, new v), as the reference's ``upd``."""
        g = g.to(torch.float32) * scale
        m_new = self.b1 * m + (1 - self.b1) * g
        v_new = self.b2 * v + (1 - self.b2) * torch.square(g)
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        delta = m_hat / (_sqrt(v_hat) + self.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + self.weight_decay * p.to(torch.float32)
        return (-lr * delta).to(torch.float32), m_new, v_new

    def update(self, grads: Any, state: AdamWState, params: Any) -> tuple[Any, AdamWState]:
        step, lr, scale, bc1, bc2 = self._prepare(grads, state)
        out = [
            self._leaf(g, m, v, p, lr, scale, bc1, bc2)
            for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                                  tree_leaves(state.v), tree_leaves(params))
        ]
        return (
            tree_unflatten(grads, [o[0] for o in out]),
            AdamWState(
                step=step,
                m=tree_unflatten(grads, [o[1] for o in out]),
                v=tree_unflatten(grads, [o[2] for o in out]),
            ),
        )

    def apply(self, grads: Any, state: AdamWState, params: Any) -> tuple[Any, AdamWState]:
        """:meth:`update` followed by ``(p + u).to(p.dtype)``, leaf by leaf,
        with equal results.  The moments of ``state`` are overwritten in
        place (the returned state shares them): ``state`` is spent."""
        step, lr, scale, bc1, bc2 = self._prepare(grads, state)
        new_params = []
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
                              tree_leaves(params)):
            u, m_new, v_new = self._leaf(g, m, v, p, lr, scale, bc1, bc2)
            m.copy_(m_new)
            v.copy_(v_new)
            new_params.append((p + u).to(p.dtype))
            del u, m_new, v_new
        return tree_unflatten(params, new_params), AdamWState(step=step, m=state.m, v=state.v)
