"""Carry parameter and cache trees across from the reference's layout.

The reference's trees are nested dicts and lists with a stacked ``cycles``
dim on ``blocks``/``scan`` entries; as numpy arrays (``jax.tree.map(
np.asarray, tree)``) their leaves are plain numpy dtypes or, for bfloat16,
``ml_dtypes.bfloat16`` arrays.  :func:`to_torch` maps such a tree onto the
port's identical structure of torch tensors, bit for bit, without importing
``ml_dtypes``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import tree_map


def array_to_tensor(a: Any) -> torch.Tensor:
    """One numpy leaf → tensor; bfloat16 arrays are reinterpreted bitwise."""
    a = np.array(a)  # a writable, contiguous copy (jax hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_torch(tree: Any) -> Any:
    """A tree of numpy arrays (params or a decode cache) → the same tree of
    CPU tensors."""
    return tree_map(array_to_tensor, tree)
