"""Hand-written CUDA kernels for the engine's routing hot path.

Each kernel package holds

* ``csrc/<name>.cu`` — the CUDA C++ kernel for Hopper (``sm_90a``) with a
  plain C launcher, built at first use by :mod:`._build`;
* ``ops.py`` — the wrapper: checks its inputs, launches the kernel for a
  CUDA tensor (counting launches), or runs the plain version for a CPU
  tensor;
* ``ref.py`` — the plain PyTorch version.

``keygroup_partition`` (hash partition + arrival histogram) and
``radix_sort`` (stable bucketed argsort of the routing composite) replace
the reference package's Pallas kernels of the same names.
"""

from repro_torch.kernels.keygroup_partition import keygroup_partition
from repro_torch.kernels.radix_sort import bucket_argsort

#: Wrapper name → wrapper, for launch accounting.
KERNELS = {
    "keygroup_partition": keygroup_partition,
    "radix_sort": bucket_argsort,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["KERNELS", "bucket_argsort", "keygroup_partition", "launch_counts",
           "reset_launch_counts"]
