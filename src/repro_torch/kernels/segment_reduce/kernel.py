"""ctypes wrapper of the CUDA segment sum (csrc/segment_reduce.cu)."""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import (SM_COUNT, SMEM_BYTES, CudaKernel,
                                  check_same_cuda, sm_count)

_P, _I = ctypes.c_void_p, ctypes.c_int

DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
          torch.float64: 3}
SEG_DTYPES = (torch.int32, torch.int64)   # taken natively
MODES = {"direct": 0, "shared": 1, "global": 2}
THREADS = 512            # the kernel's block (csrc: SUM_THREADS)
DIRECT_ROWS = 8192       # up to this many rows and segments: one block

KERNEL = CudaKernel(
    "segment_reduce",
    Path(__file__).parent / "csrc" / "segment_reduce.cu",
    {"segment_sum": (_P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _P,
                     _P)})


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's launch plan: the mode (see the source's header),
    ``blocks`` blocks of THREADS, ``smem_bytes`` of shared memory for the
    per-block sums, and whether the call zeroes the output first."""
    mode: str
    blocks: int
    smem_bytes: int
    memset: bool


def plan(r: int, s: int, itemsize: int, sms: int = SM_COUNT) -> Plan:
    """The mode for ``r`` rows into ``s`` segments of ``itemsize`` bytes:
    one block for at most DIRECT_ROWS rows and segments (it zeroes and
    writes every output itself); per-block sums in shared memory where the
    S-entry table fits and a block reads at least 4 rows per segment (its
    flush then costs at most a quarter of its rows' atomics); global
    atomics otherwise."""
    table = s * itemsize
    if r <= DIRECT_ROWS and s <= DIRECT_ROWS:
        return Plan("direct", 1, table, False)
    if table <= SMEM_BYTES:
        blocks = min(sms, -(-r // DIRECT_ROWS))
        if 4 * s <= r // blocks:
            return Plan("shared", blocks, table, True)
    blocks = max(1, min(4 * sms, -(-r // (4 * THREADS))))
    return Plan("global", blocks, 0, True)


def _launch(values: Optional[torch.Tensor], seg: torch.Tensor,
            num_segments: int, dtype: torch.dtype) -> torch.Tensor:
    dev = seg.device
    if seg.dtype not in SEG_DTYPES:
        seg = seg.to(torch.int32)
    seg = seg.contiguous()
    r = seg.shape[0]
    if r == 0 or num_segments == 0:
        return torch.zeros(num_segments, dtype=dtype, device=dev)
    p = plan(r, num_segments, dtype.itemsize,
             sm_count(dev))
    out = torch.empty(num_segments, dtype=dtype, device=dev)
    KERNEL.launch("segment_sum", dev,
                  None if values is None else values.data_ptr(),
                  seg.data_ptr(), r, num_segments, DTYPES[dtype],
                  seg.element_size(), MODES[p.mode], p.blocks,
                  out.data_ptr())
    return out


def _check_segments(seg: torch.Tensor, num_segments: int) -> None:
    if seg.dtype.is_floating_point or seg.dtype.is_complex:
        raise TypeError(f"segment ids must be integers, got {seg.dtype}")
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"num_segments {num_segments} out of range")


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values: (R,) int32/int64/float32/float64; seg: (R,) integer (int32
    and int64 taken as they are).  Rows with seg outside
    [0, num_segments) are dropped.  Returns (num_segments,) in values'
    dtype.  The arguments are checked before the device."""
    if values.dtype not in DTYPES:
        raise TypeError(f"segment_sum kernel takes {list(DTYPES)}, got "
                        f"{values.dtype}")
    if values.dim() != 1 or seg.shape != values.shape:
        raise ValueError("segment_sum takes 1-D values and segments of "
                         "one length")
    _check_segments(seg, num_segments)
    check_same_cuda(values, seg)
    return _launch(values.contiguous(), seg, num_segments, values.dtype)


def segment_count(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The count mode: rows per segment, (num_segments,) int32, rows with
    seg outside [0, num_segments) dropped.  Reads no values."""
    if seg.dim() != 1:
        raise ValueError("segment_count takes 1-D segments")
    _check_segments(seg, num_segments)
    check_same_cuda(seg)
    return _launch(None, seg, num_segments, torch.int32)
