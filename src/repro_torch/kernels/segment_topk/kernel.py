"""ctypes wrapper of the CUDA per-segment top-k (csrc/segment_topk.cu)."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import CudaKernel, check_same_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

# the kernel keeps two S-entry key tables in shared memory
MAX_SEGMENTS = 2048
# the reference kernel's envelope; the k rounds each re-read every row
MAX_K = 16

KERNEL = CudaKernel(
    "segment_topk",
    Path(__file__).parent / "csrc" / "segment_topk.cu",
    {"segment_topk": (_P, _P, ctypes.c_longlong, _I, _I, _P, _P, _P)})


def segment_topk_idx(values: torch.Tensor, seg: torch.Tensor,
                     num_segments: int, k: int) -> torch.Tensor:
    """values: (R,) integer of any width, ranked as the plain version ranks
    them, clipped to [0, 2^31); seg: (R,) integer, rows outside
    [0, num_segments) dropped.  Returns (num_segments, k) int32 row
    indices, -1-filled (value desc, ties by row asc)."""
    dev = check_same_cuda(values, seg)
    if values.dtype.is_floating_point or values.dtype.is_complex:
        raise TypeError(f"segment_topk kernel ranks integers, got "
                        f"{values.dtype}")
    if values.dim() != 1 or seg.shape != values.shape:
        raise ValueError("segment_topk takes 1-D values and segments of "
                         "one length")
    if not 1 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"segment_topk kernel takes 1..{MAX_SEGMENTS} "
                         f"segments, got {num_segments}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"segment_topk kernel takes 1 <= k <= {MAX_K}, "
                         f"got {k}")
    r = values.shape[0]
    if r >= 2**31:
        raise ValueError(f"{r} rows exceed int32 row indices")
    if values.dtype != torch.int32:
        # the kernel clips negatives itself; wider values saturate at
        # 2^31 - 1 as in the plain version's composite key
        values = values.long().clamp_(0, 2**31 - 1)
    values = values.to(torch.int32).contiguous()
    seg = seg.to(torch.int32).contiguous()
    out = torch.empty((num_segments, k), dtype=torch.int32, device=dev)
    if r == 0:
        return out.fill_(-1)
    table = torch.empty((k, num_segments), dtype=torch.int64, device=dev)
    KERNEL.launch("segment_topk", dev, values.data_ptr(), seg.data_ptr(),
                  r, num_segments, k, table.data_ptr(), out.data_ptr())
    return out
