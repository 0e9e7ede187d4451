from repro_torch.kernels.radix_sort.ops import bucket_argsort

__all__ = ["bucket_argsort"]
