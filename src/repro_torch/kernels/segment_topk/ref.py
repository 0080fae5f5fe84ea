"""Plain PyTorch version of the per-segment top-k: one composite-key
stable argsort (ascending segment, descending clipped value, ties by row)
— the same formulation as core/enrich/ops.py's ``_segment_topk_ref``."""

from __future__ import annotations

import torch


def segment_topk_idx(values: torch.Tensor, seg: torch.Tensor,
                     num_segments: int, k: int) -> torch.Tensor:
    """values: (R,) int (negatives rank as 0); seg: (R,) int, rows outside
    [0, num_segments) dropped.  Returns (num_segments, k) int32 row
    indices, -1-filled."""
    r = values.shape[0]
    dev = values.device
    vmax = 1 << 31
    v = torch.clamp(values.to(torch.int64), 0, vmax - 1)
    seg = seg.to(torch.int64)
    segi = torch.where((seg >= 0) & (seg < num_segments), seg,
                       num_segments)
    composite = segi * vmax + (vmax - 1 - v)   # asc seg, desc value
    order = torch.sort(composite, stable=True).indices
    sseg = segi[order]
    starts = torch.searchsorted(
        sseg, torch.arange(num_segments + 1, dtype=torch.int64, device=dev))
    pos = torch.arange(r, device=dev) - starts[torch.clamp(sseg, 0,
                                                           num_segments)]
    keep = (pos < k) & (sseg < num_segments)
    slot = torch.where(keep, sseg * k + pos, num_segments * k)
    out = torch.full((num_segments * k + 1,), -1, dtype=torch.int32,
                     device=dev)
    out.scatter_(0, slot, torch.where(keep, order, -1).to(torch.int32))
    return out[:-1].reshape(num_segments, k)
