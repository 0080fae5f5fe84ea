"""Per-segment top-k routed by device.  The hand kernel for the card is not
written yet (ROADMAP, Queue 2: ``segment_topk``), so a CUDA tensor
raises instead of quietly taking the plain version; CPU and meta tensors
take the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.segment_topk import ref


def segment_topk_idx(values: torch.Tensor, seg: torch.Tensor,
                     num_segments: int, k: int) -> torch.Tensor:
    """Per-segment top-k selection INDICES ((S, k) int32 rows, -1-filled;
    value desc, ties by row asc)."""
    if on_cuda(values):
        raise NotImplementedError(
            "the segment_topk CUDA kernel is not ported yet (ROADMAP, "
            "Queue 2); inside its envelope a CUDA tensor has no kernel "
            "to run")
    return ref.segment_topk_idx(values, seg, num_segments, k)
