"""Checkpoint/restart for the streaming engine, without jax.

The port of ``repro.checkpoint.checkpoint``, with the same invariants:

* **Atomicity** — a checkpoint directory is staged under ``<dir>.tmp`` and
  ``os.rename``d into place; the ``MANIFEST.json`` is written last inside the
  stage, so a directory with a manifest is complete by construction.
* **Versioned retention** — ``keep`` newest checkpoints are retained; garbage
  is pruned after a successful commit, never before.
* **Async** — ``save_async`` snapshots the leaves to host numpy arrays
  synchronously (torch tensors are copied off their device, as the
  reference's ``np.asarray`` copies a jax array) and writes in a background
  thread.
* **Self-describing** — arrays go into ``arrays.npz``; the tree structure
  and each leaf's dtype string are pickled alongside; the manifest records
  step, wall time and user metadata (the ingestion cursor, the sink mark).

Layout: ``MANIFEST.json`` and ``arrays.npz`` are the reference's, leaf for
leaf (dict keys in sorted order, as ``jax.tree.flatten`` orders them;
bfloat16 and float8 leaves stored as unsigned-integer views beside their
dtype string).  The one file whose content differs is ``treedef.pkl``: the
reference pickles a jax ``PyTreeDef`` there, which cannot be read without
jaxlib, and this module pickles its own structure description — nested
tuples over dict, list, tuple, None and dataclasses with numpy or torch
leaves.  A dataclass (the optimizer's ``AdamWState``, which the reference
registers with ``jax.tree_util.register_dataclass``) is described by its
class's import path and its fields in declaration order, the order in
which jax flattens it, so a ``(params, AdamWState)`` tree writes the
reference's leaves in the reference's order.  A payload crosses between
the packages through ``arrays.npz`` (see
:func:`repro_torch.engine.checkpointing.payload_from_tree`), never through
``treedef.pkl``.

Leaves are numpy arrays, torch tensors or scalars (stored as 0-d arrays).
A torch leaf loads back as a CPU torch tensor of its dtype (bfloat16
included, without ``ml_dtypes``); a numpy leaf loads as a numpy array.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pickle
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

MANIFEST = "MANIFEST.json"

#: Torch dtypes numpy cannot hold: stored as unsigned views with the dtype
#: string the reference writes for the same ml_dtypes type.
_VIEW_DTYPES = {
    torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8),
}
_BY_NAME = {name: (dt, view) for dt, (name, view, _) in _VIEW_DTYPES.items()}


def _encode(x: Any) -> tuple[str, np.ndarray, str]:
    """(leaf kind, npz-safe host array, dtype string) of one leaf.

    Torch leaves are copied off their device (a fresh host array, so a later
    in-place update of the tensor cannot reach an async write)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype in _VIEW_DTYPES:
            name, view, np_view = _VIEW_DTYPES[t.dtype]
            arr = t.view(view).to("cpu", copy=True).numpy().view(np_view)
            return "torch", arr, name
        arr = t.to("cpu", copy=True).numpy()
        return "torch", arr, str(arr.dtype)
    arr = np.asarray(x)
    dt = str(arr.dtype)
    if arr.dtype.kind == "V" or dt in _BY_NAME:
        # A reference-style ml_dtypes array handed in directly.
        width = np.uint16 if dt == "bfloat16" else np.uint8
        return "numpy", arr.view(width), dt
    return "numpy", arr, dt


def _decode(kind: str, arr: np.ndarray, dt: str):
    if dt in _BY_NAME:
        # bfloat16 / float8 have no numpy dtype here: they come back as
        # torch tensors whichever package wrote them.
        torch_dt, view = _BY_NAME[dt]
        return torch.from_numpy(np.ascontiguousarray(arr)).view(torch_dt)
    if kind == "torch":
        return torch.from_numpy(np.ascontiguousarray(arr))
    return arr


def _sorted_keys(d: dict) -> list:
    try:
        return sorted(d)
    except TypeError:
        return list(d)


def _flatten(tree: Any, leaves: list) -> Any:
    """Append ``tree``'s leaves in order; return its structure description."""
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = _sorted_keys(tree)
        return ("dict", tuple((k, _flatten(tree[k], leaves)) for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(_flatten(x, leaves) for x in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        cls = type(tree)
        fields = tuple((f.name, _flatten(getattr(tree, f.name), leaves))
                       for f in dataclasses.fields(tree))
        return ("dataclass", f"{cls.__module__}:{cls.__qualname__}", fields)
    leaves.append(tree)
    return ("leaf",)


def _unflatten(struct: Any, leaves) -> Any:
    kind = struct[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(leaves)
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in struct[1]}
    if kind == "dataclass":
        module, qualname = struct[1].split(":")
        cls = importlib.import_module(module)
        for part in qualname.split("."):
            cls = getattr(cls, part)
        return cls(**{name: _unflatten(s, leaves) for name, s in struct[2]})
    items = [_unflatten(s, leaves) for s in struct[1]]
    return items if kind == "list" else tuple(items)


def _host_snapshot(tree: Any) -> tuple[Any, list[tuple[str, np.ndarray, str]]]:
    leaves: list = []
    struct = _flatten(tree, leaves)
    return struct, [_encode(x) for x in leaves]


def _write(path: str, struct: Any, encoded: list, metadata: Optional[dict]) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    stage = path + ".tmp"
    if os.path.exists(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    np.savez(os.path.join(stage, "arrays.npz"), *[e[1] for e in encoded])
    with open(os.path.join(stage, "treedef.pkl"), "wb") as f:
        pickle.dump((struct, [(e[0], e[2]) for e in encoded]), f)
    with open(os.path.join(stage, MANIFEST), "w") as f:
        json.dump(
            {
                "num_leaves": len(encoded),
                "written_at": time.time(),
                "metadata": metadata or {},
            },
            f,
        )
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(stage, path)


def save_pytree(path: str, tree: Any, *, metadata: Optional[dict] = None) -> None:
    """Synchronous atomic save of one tree to a checkpoint directory."""
    struct, encoded = _host_snapshot(tree)
    _write(path, struct, encoded, metadata)


def load_pytree(path: str) -> tuple[Any, dict]:
    """Load (tree, metadata) from a checkpoint directory this module wrote."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "treedef.pkl"), "rb") as f:
        struct, kinds = pickle.load(f)
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=True) as z:
        leaves = [_decode(kind, z[k], dt) for k, (kind, dt) in zip(z.files, kinds)]
    return _unflatten(struct, iter(leaves)), manifest.get("metadata", {})


class CheckpointManager:
    """Step-indexed checkpoints with retention and async writing."""

    def __init__(self, directory: str, *, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._prune_stages()

    def _prune_stages(self) -> None:
        """Remove stage directories a killed writer left behind.

        A crash between staging and the ``os.rename`` commit leaves a
        ``step_*.tmp`` directory — possibly with a complete manifest inside.
        It was never committed, so it is garbage: prune it on construction
        (create the manager before starting new saves).
        """
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            # Committed checkpoints only: a stage dir ("step_*.tmp") can hold
            # a manifest too (it is written last *inside* the stage), but an
            # unrenamed stage was never committed — skip non-numeric suffixes.
            tail = name[len("step_") :]
            if (
                name.startswith("step_")
                and tail.isdigit()
                and os.path.exists(os.path.join(self.directory, name, MANIFEST))
            ):
                out.append(int(tail))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- writing --------------------------------------------------------------
    def save(self, step: int, tree: Any, *, metadata: Optional[dict] = None) -> None:
        self.wait()
        save_pytree(
            self._step_dir(step),
            tree,
            metadata={"step": step, **(metadata or {})},
        )
        self._prune()

    def save_async(
        self, step: int, tree: Any, *, metadata: Optional[dict] = None
    ) -> None:
        """Snapshot now (host copies), write in the background."""
        self.wait()
        struct, encoded = _host_snapshot(tree)

        def work() -> None:
            _write(
                self._step_dir(step),
                struct,
                encoded,
                {"step": step, **(metadata or {})},
            )
            self._prune()

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- reading --------------------------------------------------------------
    def restore(self, step: Optional[int] = None) -> tuple[Any, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return load_pytree(self._step_dir(step))
