from repro_torch.kernels.hash_probe.ops import sorted_probe  # noqa: F401
