"""What the process that prints a result may not have loaded: JAX, its
libraries, or the JAX package the port was made from (``repro``).  Names are
compared by their top-level part whole, so ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {name.partition(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))
