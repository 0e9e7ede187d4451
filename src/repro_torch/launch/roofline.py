"""Roofline terms of a step, counted from a trace of it on the meta device.

The port of ``repro.launch.roofline``.  The reference reads its terms from
the optimized HLO text of the compiled module; the port runs the step on
meta tensors (shapes and dtypes, no storage, no launch) under
:class:`OpCounter`, a ``TorchDispatchMode`` that sees every aten op the
step dispatches, its backward and the optimizer included.  Per device, in
seconds (lower-bound estimates):

    compute    = trace_FLOPs / (chips × PEAK_FLOPS)
    memory     = trace_bytes / (chips × HBM_BW)
    collective = 0 (the port runs on one device: no collective)

* **FLOPs** — each op with a formula in ``torch.utils.flop_counter``
  (``mm``/``bmm``/``addmm``/``baddbmm``, into which einsum and ``@``
  lower: 2·M·N·K), and each kernel op's own count (below).  Elementwise
  FLOPs are left out, as the reference leaves out everything but ``dot``.
* **bytes** — each op's inputs read once and outputs written once.  Views
  and aliases (``view``, ``expand``, ``as_strided``, ``detach``, …) and
  allocations (``empty*``) cost nothing, the counterpart of the reference's
  bookkeeping ops; fills (``zeros_like``, ``fill_``, …) write their output
  only; a broadcast (stride-0) dim is read once.  A gather
  (``index``, ``gather``, ``embedding``, ``index_select``) reads the rows
  it returns, not its whole source; an in-place scatter (``index_put_``,
  ``scatter_``, ``index_add_``, …) reads and writes the rows it updates,
  and ``copy_`` reads its source and writes its destination, as the
  reference counts dynamic-slice and dynamic-update-slice windows.
* **kernel ops** — on meta tensors the LM kernels' wrappers record one op
  each (:mod:`repro_torch.kernels.meta`): each input read and each output
  written once, the operations of the kernel's body (causal flash counts
  the triangle it computes; decode the cache's whole capacity; moe_gemm
  dense x).
* **loops** — a Python loop written with
  :func:`repro_torch.models.common.loop_steps` runs its body once, its ops
  weighted by the trip count, as the reference weights a while body.

Hardware constants: the H100 SXM's data-sheet peaks (dense bf16 tensor
cores, HBM3); :func:`card` names the card they are stated beside.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import shutil
import subprocess
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import meta as kernel_meta
from repro_torch.models import common

PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM
HBM_BW = 3.35e12  # bytes/s, H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # non-tensor-core f32 FLOP/s, H100 SXM
PEAK_INT32_OPS = 67e12  # non-tensor-core int32 op/s, H100 SXM
HBM_CAPACITY = 80e9  # bytes of device memory, H100 80 GB

_aten = torch.ops.aten
#: Ops that allocate without writing (cost 0).
_ALLOC_OPS = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided,
}
#: Ops that alias their input without moving data, beyond the schema's views.
_ALIAS_OPS = {
    _aten.detach, _aten.alias, _aten.lift_fresh, _aten._unsafe_view, _aten.set_,
    _aten.resize_, _aten.as_strided_,
}
#: Fills: they write their output and read no input's data.
_FILL_OPS = {
    _aten.zeros_like, _aten.ones_like, _aten.full_like, _aten.new_zeros, _aten.new_ones,
    _aten.new_full, _aten.fill_, _aten.zero_,
}
#: Gathers: they read the rows they return (plus indices).
_GATHER_OPS = {_aten.index, _aten.gather, _aten.embedding, _aten.index_select}
#: In-place scatters: they read and write the rows they update (plus indices).
_SCATTER_OPS = {
    _aten.index_put_, _aten.scatter_, _aten.scatter_add_, _aten.index_add_,
    _aten.index_copy_, _aten._index_put_impl_,
}


def storage_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor spans once: a broadcast (stride-0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class OpCounts:
    flops: float = 0.0
    bytes: float = 0.0
    #: op name → [weighted calls, flops, bytes]
    by_op: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float, weight: float) -> None:
        self.flops += flops * weight
        self.bytes += nbytes * weight
        row = self.by_op.setdefault(name, [0.0, 0.0, 0.0])
        row[0] += weight
        row[1] += flops * weight
        row[2] += nbytes * weight

    def kernel_ops(self) -> dict[str, float]:
        """Weighted count of each kernel's recorded ops."""
        return {k[len("kernel:"):]: v[0] for k, v in self.by_op.items()
                if k.startswith("kernel:")}

    def top(self, n: int = 10) -> list[tuple[str, float, float, float]]:
        """The ``n`` ops that move the most bytes: (name, calls, flops, bytes)."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])[:n]
        return [(name, *vals) for name, vals in rows]


@functools.lru_cache(maxsize=None)
def _schema_info(func) -> tuple[bool, tuple[str, ...], dict[str, bool]]:
    """(is a view, argument names, written argument → is an ``out=``)."""
    args = func._schema.arguments
    view = any(a.alias_info is not None and not a.alias_info.is_write for a in args)
    writes = {a.name: bool(getattr(a, "is_out", False)) for a in args
              if a.alias_info is not None and a.alias_info.is_write}
    return view, tuple(a.name for a in args), writes


def op_bytes(func, args, kwargs, out) -> float:
    """Bytes one aten op moves (see the module docstring)."""
    packet = func.overloadpacket
    view, names, writes = _schema_info(func)
    if view or packet in _ALLOC_OPS or packet in _ALIAS_OPS:
        return 0.0
    if packet in _FILL_OPS:
        return sum(storage_bytes(t) for t in _tensors(out))
    if packet is _aten.copy_:
        return storage_bytes(args[1]) + storage_bytes(args[0])
    if packet in _GATHER_OPS:
        idx = _tensors((args[1:], kwargs))
        return sum(storage_bytes(t) for t in idx) + 2 * sum(storage_bytes(t) for t in _tensors(out))
    if packet in _SCATTER_OPS:
        dst = args[0]
        rest = _tensors((args[1:], kwargs))
        if not rest:
            return 0.0
        src = max(rest, key=lambda t: t.numel())
        idx = sum(storage_bytes(t) for t in rest if t is not src)
        return idx + storage_bytes(src) + src.numel() * dst.element_size()
    bound = dict(zip(names, args))
    bound.update(kwargs)
    total = 0.0
    for name, value in bound.items():
        for t in _tensors(value):
            if name not in writes:
                total += storage_bytes(t)  # read
            else:
                total += storage_bytes(t) * (1 if writes[name] else 2)  # (read and) write
    if not writes:
        total += sum(storage_bytes(t) for t in _tensors(out))
    return total


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op dispatched under it, and of
    the kernels' meta ops; :func:`repro_torch.models.common.loop_steps`
    loops are folded, weighted by their trip counts."""

    def __init__(self):
        super().__init__()
        self.counts = OpCounts()
        self.weight = 1.0
        # Folded loops' autograd sequence-number ranges (start, end, trips):
        # the backward of a node made inside one is weighted by its trips.
        self._starts: list[int] = []
        self._ranges: list[tuple[int, int, int]] = []

    def _weight(self) -> float:
        if self.weight != 1.0:  # inside a folded loop (forward or recompute)
            return self.weight
        node = torch._C._current_autograd_node()
        if node is None or not self._ranges:
            return 1.0
        seq = node._sequence_nr()
        i = bisect.bisect_right(self._starts, seq) - 1
        if i >= 0:
            start, end, trips = self._ranges[i]
            if start < seq < end:
                return float(trips)
        return 1.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = op_bytes(func, args, kwargs, out)
        if flops or nbytes:
            self.counts.add(str(packet).split(".")[-1], flops, nbytes, self._weight())
        return out

    def _record(self, name: str, flops: float, nbytes: float) -> None:
        self.counts.add(f"kernel:{name}", flops, nbytes, self._weight())

    @staticmethod
    def _sequence_nr() -> int:
        """The autograd sequence number the next node made here would take
        (a zero-cost view of a throwaway leaf)."""
        with torch.enable_grad():
            leaf = torch.empty(0, device="meta", requires_grad=True)
            return leaf.view(0).grad_fn._sequence_nr()

    @contextlib.contextmanager
    def _fold(self, n: int):
        saved = self.weight
        start = self._sequence_nr()
        self.weight = saved * n
        try:
            yield
        finally:
            self.weight = saved
            end = self._sequence_nr()
            if end > start + 1:
                self._starts.append(start)
                self._ranges.append((start, end, n))

    def __enter__(self):
        kernel_meta.RECORDERS.append(self._record)
        common._LOOP_FOLD.append(self._fold)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            common._LOOP_FOLD.pop()
            kernel_meta.RECORDERS.pop()


def count_ops(fn, *args, **kwargs) -> tuple[Any, OpCounts]:
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`: (its result,
    the counts)."""
    with OpCounter() as counter:
        result = fn(*args, **kwargs)
    return result, counter.counts


def card() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, or None where there is none."""
    if not shutil.which("nvidia-smi"):
        return None
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = got.stdout.strip().splitlines()
    return lines[0].strip() if got.returncode == 0 and lines else None


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    trace_flops_per_device: float
    trace_bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    collectives: dict[str, int]
    bytes_per_device_hbm: Optional[float] = None  # arguments + outputs

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def useful_flops_ratio(self) -> float:
        total = self.trace_flops_per_device * self.chips
        return self.model_flops / total if total > 0 else float("nan")

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "trace_flops_total": self.trace_flops_per_device * self.chips,
            "useful_ratio": self.useful_flops_ratio,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "hbm_bytes_per_device": self.bytes_per_device_hbm,
            "collectives": self.collectives,
        }


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def build_report(
    *,
    arch: str,
    shape,
    cfg,
    mesh_name: str,
    chips: int,
    counts: OpCounts,
    memory_bytes: Optional[float] = None,
) -> RooflineReport:
    return RooflineReport(
        arch=arch,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        trace_flops_per_device=counts.flops,
        trace_bytes_per_device=counts.bytes,
        wire_bytes_per_device=0.0,
        model_flops=model_flops_estimate(cfg, shape),
        compute_s=counts.flops / PEAK_FLOPS,
        memory_s=counts.bytes / HBM_BW,
        collective_s=0.0,
        collectives={},
        bytes_per_device_hbm=memory_bytes,
    )
