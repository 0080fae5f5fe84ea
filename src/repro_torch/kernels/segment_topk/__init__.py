from repro_torch.kernels.segment_topk.ops import segment_topk_idx  # noqa: F401
