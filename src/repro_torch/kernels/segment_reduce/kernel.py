"""ctypes wrapper of the CUDA segment sum (csrc/segment_reduce.cu)."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import CudaKernel, check_same_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
          torch.float64: 3}

KERNEL = CudaKernel(
    "segment_reduce",
    Path(__file__).parent / "csrc" / "segment_reduce.cu",
    {"segment_sum": (_P, _P, ctypes.c_longlong, _I, _I, _P, _P)})


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values: (R,) int32/int64/float32/float64; seg: (R,) integer.  Rows
    with seg outside [0, num_segments) are dropped.  Returns
    (num_segments,) in values' dtype."""
    dev = check_same_cuda(values, seg)
    code = DTYPES.get(values.dtype)
    if code is None:
        raise TypeError(f"segment_sum kernel takes {list(DTYPES)}, got "
                        f"{values.dtype}")
    if values.dim() != 1 or seg.shape != values.shape:
        raise ValueError("segment_sum takes 1-D values and segments of "
                         "one length")
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"num_segments {num_segments} out of range")
    values = values.contiguous()
    seg = seg.to(torch.int32).contiguous()
    out = torch.zeros(num_segments, dtype=values.dtype, device=dev)
    r = values.shape[0]
    if r and num_segments:
        KERNEL.launch("segment_sum", dev, values.data_ptr(),
                      seg.data_ptr(), r, num_segments, code,
                      out.data_ptr())
    return out
