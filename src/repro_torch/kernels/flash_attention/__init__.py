from repro_torch.kernels.flash_attention.ops import flash_attention, kernel_path

__all__ = ["flash_attention", "kernel_path"]
