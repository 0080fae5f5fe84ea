"""ctypes wrapper of the CUDA spatial-grid radius top-k join
(csrc/spatial_join.cu).

The kernel bins the reference points into square cells of side about the
radius, hashed into a power-of-two bucket table, and each probe visits
the cells of its box.  ``grid_plan`` computes, on the host and from the
arguments alone, what the four launches need: the float32 bound on d2,
the widened radius that bounds every counted pair's offset, the cell
function's factor, the bucket count and the scratch size.  Nothing of
the data is read back."""

from __future__ import annotations

import ctypes
import dataclasses
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import CudaKernel, check_same_cuda
from repro_torch.kernels.spatial_join.ref import radius2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

MAX_K = 16
MIN_BUCKETS = 4096       # csrc: MIN_BUCKETS
BUCKET_ROWS = 4          # rows per bucket, rounded up to a power of two
MAX_BUCKETS = 1 << 22
WIDEN = 2.0 ** -20       # the radius' relative widening (>> 2 ulps)
MAX_INV_CELL = 2.0 ** 64  # caps 1 / cell for a zero radius

KERNEL = CudaKernel(
    "spatial_join", Path(__file__).parent / "csrc" / "spatial_join.cu",
    {"radius_join": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I,
                     _P, _P, _P, _P, _P)})


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """One call's plan: ``r2`` the float32 bound on d2; ``radius_w`` a
    float32 radius that bounds |px - x| (and |py - y|) of every pair with
    d2 <= r2, and the cell side; ``inv_cell`` the float32 factor of the
    cell function floor(v * inv_cell); ``buckets`` (a power of two)
    hashed cells; ``scratch_bytes`` for the bucket starts, the binned
    points and their ranks."""
    r2: float
    radius_w: float
    inv_cell: float
    buckets: int
    scratch_bytes: int


def widened_radius(r2: float) -> float:
    """sqrt(r2) * (1 + WIDEN), rounded up to float32.  A pair with
    fl(fl(dx^2) + fl(dy^2)) <= r2 has an exact offset below
    sqrt(r2) * (1 + 2^-23) on each axis, which this bounds."""
    w = math.sqrt(r2) * (1.0 + WIDEN)
    f = np.float32(w)
    if float(f) < w:
        f = np.nextafter(f, np.float32(np.inf))
    return float(f)


def bucket_count(r: int) -> int:
    """A power of two of one bucket per 2-4 reference rows, within
    [MIN_BUCKETS, MAX_BUCKETS]: one block scans the counts, so fewer
    buckets cost it less than the extra candidates cost the probes."""
    n = 1 << max(0, (max(r, 1) - 1).bit_length())
    return min(MAX_BUCKETS, max(MIN_BUCKETS, n // BUCKET_ROWS))


def scratch_layout(r: int, buckets: int) -> Tuple[int, int, int]:
    """Byte offsets of the binned points and the ranks, and the total:
    starts int32[buckets + 2] (the last two: the binned total and the
    done counter) padded to 16 bytes, points float4[r], ranks int32[r]."""
    pts = -(-(buckets + 2) * 4 // 16) * 16
    return pts, pts + 16 * r, pts + 20 * r


def grid_plan(r: int, radius: float) -> GridPlan:
    """The plan for ``r`` reference rows at ``radius``; raises outside
    the kernel's envelope (a non-finite r2).  Cells have the side
    radius_w, so a probe's box spans 2-3 cells an axis."""
    r2 = radius2(radius)
    if not math.isfinite(r2):
        raise ValueError(f"radius_join kernel takes a radius whose float32 "
                         f"square is finite, got {radius}")
    rw = widened_radius(r2)
    inv = float(np.float32(min(1.0 / rw, MAX_INV_CELL))) if rw > 0 \
        else MAX_INV_CELL
    nb = bucket_count(r)
    return GridPlan(r2, rw, inv, nb, scratch_layout(r, nb)[2])


def radius_join(px: torch.Tensor, py: torch.Tensor, rx: torch.Tensor,
                ry: torch.Tensor, radius: float, k: int,
                ref_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """px, py: (B,) float32; rx, ry: (R,) float32; ref_valid: (R,) bool.
    Returns (idx (B,k) int32 [-1], dist2 (B,k) float32 [inf],
    count (B,) int32).  The arguments are checked before the device:
    outside the envelope it raises anywhere."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"radius_join kernel takes 1 <= k <= {MAX_K}, "
                         f"got {k}")
    for a in (px, py, rx, ry):
        if a.dtype != torch.float32 or a.dim() != 1:
            raise TypeError("radius_join takes 1-D float32 coordinates, "
                            f"got {a.dtype} {tuple(a.shape)}")
    b, r = px.shape[0], rx.shape[0]
    if py.shape[0] != b or ry.shape[0] != r:
        raise ValueError("radius_join coordinate lengths differ")
    if ref_valid is not None and ref_valid.shape != (r,):
        raise ValueError("radius_join: ref_valid must be (R,)")
    if max(b, r) >= 2**31:
        raise ValueError(f"radius_join: {max(b, r)} rows exceed int32 "
                         "indices")
    plan = grid_plan(r, radius)
    ops = [px, py, rx, ry] + ([] if ref_valid is None else [ref_valid])
    dev = check_same_cuda(*ops)
    px, py, rx, ry = (a.contiguous() for a in (px, py, rx, ry))
    valid_ptr = None
    if ref_valid is not None:
        ref_valid = ref_valid.to(torch.bool).contiguous()
        valid_ptr = ref_valid.data_ptr()
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, k), dtype=torch.float32, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    if b:
        scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                              device=dev)
        KERNEL.launch("radius_join", dev, px.data_ptr(), py.data_ptr(),
                      rx.data_ptr(), ry.data_ptr(), valid_ptr, b, r,
                      plan.r2, plan.radius_w, plan.inv_cell, plan.buckets,
                      k, scratch.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                      count.data_ptr())
    return idx, d2, count
