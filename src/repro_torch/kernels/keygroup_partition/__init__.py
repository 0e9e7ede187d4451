from repro_torch.kernels.keygroup_partition.ops import fold_keys64, keygroup_partition

__all__ = ["fold_keys64", "keygroup_partition"]
