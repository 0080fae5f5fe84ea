"""Plain PyTorch version of the spatial radius top-k join.

The same arithmetic as the CUDA kernel: d2 = dx*dx + dy*dy in float32,
each operation rounded on its own, compared against the float32 square of
the radius.  Ties go to the lower reference index (a stable sort), so the
kernel and this version agree bit for bit on any device."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

CHUNK = 512   # probe rows per distance tile (bounds the (chunk, R) tile)


def radius2(radius: float) -> float:
    """float32(radius)**2 rounded to float32 — the comparison bound both
    the kernel and this version use."""
    r = np.float32(radius)
    return float(np.float32(r * r))


def radius_join(px: torch.Tensor, py: torch.Tensor, rx: torch.Tensor,
                ry: torch.Tensor, radius: float, k: int,
                ref_valid: Optional[torch.Tensor] = None,
                chunk: int = CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (idx (B,k) int32 [-1 fill], dist2 (B,k) float32 [inf fill],
    count (B,) int32) for the valid reference points within ``radius``,
    nearest first."""
    r2 = radius2(radius)
    b, r = px.shape[0], rx.shape[0]
    kk = min(k, r)
    dev = px.device
    px, py = px.to(torch.float32), py.to(torch.float32)
    rx, ry = rx.to(torch.float32), ry.to(torch.float32)
    idxs, dists, counts = [], [], []
    for s in range(0, max(b, 1), chunk):
        dx = px[s:s + chunk, None] - rx[None, :]
        dy = py[s:s + chunk, None] - ry[None, :]
        d2 = dx * dx + dy * dy
        if ref_valid is not None:
            d2 = torch.where(ref_valid[None, :].to(torch.bool), d2,
                             float("inf"))
        counts.append((d2 <= r2).sum(dim=1, dtype=torch.int32))
        dd, idx = torch.sort(d2, dim=1, stable=True)
        dd, idx = dd[:, :kk], idx[:, :kk]
        if kk < k:   # tiny reference table: pad the result slots
            n = dd.shape[0]
            dd = torch.cat([dd, torch.full((n, k - kk), float("inf"),
                                           device=dev)], dim=1)
            idx = torch.cat([idx, torch.full((n, k - kk), -1,
                                             dtype=idx.dtype, device=dev)],
                            dim=1)
        ok = dd <= r2
        idxs.append(torch.where(ok, idx, -1).to(torch.int32))
        dists.append(torch.where(ok, dd, float("inf")))
    return torch.cat(idxs), torch.cat(dists), torch.cat(counts)
