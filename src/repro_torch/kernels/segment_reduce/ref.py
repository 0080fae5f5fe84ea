"""Plain PyTorch version of the segment sum."""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values: (R,); seg: (R,) integer.  Rows with seg outside
    [0, num_segments) are dropped.  Returns (num_segments,) in values'
    dtype (integer sums wrap like the kernel's)."""
    seg = seg.to(torch.int64)
    keep = (seg >= 0) & (seg < num_segments)
    # dropped rows go to one extra overflow slot, cut off at the end
    slot = torch.where(keep, seg, num_segments)
    out = torch.zeros(num_segments + 1, dtype=values.dtype,
                      device=values.device)
    out.scatter_add_(0, slot, values)
    return out[:num_segments]


def segment_count(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows per segment, (num_segments,) int32; rows with seg outside
    [0, num_segments) dropped."""
    ones = torch.ones(seg.shape, dtype=torch.int32, device=seg.device)
    return segment_sum(ones, seg, num_segments)
