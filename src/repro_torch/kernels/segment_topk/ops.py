"""Per-segment top-k routed by device: CUDA tensors take the hand kernel,
CPU and meta tensors the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels import note_site, on_cuda
from repro_torch.kernels.segment_topk import kernel, ref


def segment_topk_idx(values: torch.Tensor, seg: torch.Tensor,
                     num_segments: int, k: int) -> torch.Tensor:
    """Per-segment top-k selection INDICES ((S, k) int32 rows, -1-filled;
    value desc, ties by row asc)."""
    note_site("segment_topk")
    if on_cuda(values):
        return kernel.segment_topk_idx(values, seg, num_segments, k)
    return ref.segment_topk_idx(values, seg, num_segments, k)
