"""Hand-written CUDA kernels: the engine's routing and the LM's attention,
recurrence and expert products.

Each kernel package holds

* ``csrc/<name>.cu`` — the CUDA C++ kernel for Hopper (``sm_90a``) with a
  plain C launcher, built at first use by :mod:`._build`;
* ``ops.py`` — the wrapper: checks its inputs, launches the kernel for a
  CUDA tensor (counting launches), or runs the plain version for a CPU
  tensor; the LM kernels' wrappers launch inside a
  ``torch.autograd.Function`` where a CUDA input requires grad, and count
  the launches their backward makes apart too (``backward_launches``);
* ``ref.py`` — the plain PyTorch version.

``keygroup_partition`` (hash partition + arrival histogram), ``radix_sort``
(stable bucketed argsort of the routing composite), ``flash_attention``
(causal / windowed GQA prefill attention), ``decode_attention`` (one-token
attention over a KV cache), ``rglru_scan`` (the RG-LRU linear recurrence)
and ``moe_gemm`` (the grouped expert matmul) replace the reference
package's Pallas kernels of the same names.  Code shared by several sources
lives in ``csrc/*.cuh`` here.
"""

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.keygroup_partition import keygroup_partition
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.radix_sort import bucket_argsort
from repro_torch.kernels.rglru_scan import rglru_scan

#: Wrapper name → wrapper, for launch accounting.
KERNELS = {
    "keygroup_partition": keygroup_partition,
    "radix_sort": bucket_argsort,
    "flash_attention": flash_attention,
    "decode_attention": decode_attention,
    "rglru_scan": rglru_scan,
    "moe_gemm": moe_gemm,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "backward_launches"):
            fn.backward_launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def backward_launch_counts() -> dict[str, int]:
    """Launches made by the autograd Functions' backward passes (included
    in :func:`launch_counts` too)."""
    return {name: fn.backward_launches for name, fn in KERNELS.items()
            if hasattr(fn, "backward_launches")}


__all__ = ["KERNELS", "backward_launch_counts", "bucket_argsort", "decode_attention",
           "flash_attention", "keygroup_partition", "launch_counts", "moe_gemm", "reset_launch_counts",
           "rglru_scan"]
