"""Segment sum routed by device: CUDA tensors take the hand kernel, CPU
and meta tensors the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.segment_reduce import kernel, ref


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    if on_cuda(values):
        return kernel.segment_sum(values, seg, num_segments)
    return ref.segment_sum(values, seg, num_segments)
