"""ctypes wrapper of the CUDA spatial radius top-k join
(csrc/spatial_join.cu)."""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import CudaKernel, check_same_cuda
from repro_torch.kernels.spatial_join.ref import radius2

_P, _I = ctypes.c_void_p, ctypes.c_int

MAX_K = 16

KERNEL = CudaKernel(
    "spatial_join", Path(__file__).parent / "csrc" / "spatial_join.cu",
    {"radius_join": (_P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I,
                     _P, _P, _P, _P)})


def radius_join(px: torch.Tensor, py: torch.Tensor, rx: torch.Tensor,
                ry: torch.Tensor, radius: float, k: int,
                ref_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """px, py: (B,) float32; rx, ry: (R,) float32; ref_valid: (R,) bool.
    Returns (idx (B,k) int32 [-1], dist2 (B,k) float32 [inf],
    count (B,) int32)."""
    ops = [px, py, rx, ry] + ([] if ref_valid is None else [ref_valid])
    dev = check_same_cuda(*ops)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"radius_join kernel takes 1 <= k <= {MAX_K}, "
                         f"got {k}")
    for t in (px, py, rx, ry):
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError("radius_join takes 1-D float32 coordinates, "
                            f"got {t.dtype} {tuple(t.shape)}")
    b, r = px.shape[0], rx.shape[0]
    if py.shape[0] != b or ry.shape[0] != r:
        raise ValueError("radius_join coordinate lengths differ")
    px, py, rx, ry = (t.contiguous() for t in (px, py, rx, ry))
    valid_ptr = None
    if ref_valid is not None:
        if ref_valid.shape != (r,):
            raise ValueError("ref_valid must be (R,)")
        ref_valid = ref_valid.to(torch.bool).contiguous()
        valid_ptr = ref_valid.data_ptr()
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, k), dtype=torch.float32, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    if b:
        KERNEL.launch("radius_join", dev, px.data_ptr(), py.data_ptr(),
                      rx.data_ptr(), ry.data_ptr(), valid_ptr, b, r,
                      radius2(radius), k, idx.data_ptr(), d2.data_ptr(),
                      count.data_ptr())
    return idx, d2, count
