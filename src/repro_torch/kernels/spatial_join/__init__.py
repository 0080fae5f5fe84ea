from repro_torch.kernels.spatial_join.ops import radius_join  # noqa: F401
