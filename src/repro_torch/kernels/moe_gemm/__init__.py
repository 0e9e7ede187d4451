from repro_torch.kernels.moe_gemm.ops import moe_gemm

__all__ = ["moe_gemm"]
