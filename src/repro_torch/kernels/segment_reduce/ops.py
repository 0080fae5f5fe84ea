"""Segment sum and count routed by device: CUDA tensors take the hand
kernel, CPU and meta tensors the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels import note_site, on_cuda
from repro_torch.kernels.segment_reduce import kernel, ref


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    note_site("segment_reduce")
    if on_cuda(values):
        return kernel.segment_sum(values, seg, num_segments)
    return ref.segment_sum(values, seg, num_segments)


def segment_count(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows per segment, (num_segments,) int32."""
    note_site("segment_reduce")
    if on_cuda(seg):
        return kernel.segment_count(seg, num_segments)
    return ref.segment_count(seg, num_segments)
