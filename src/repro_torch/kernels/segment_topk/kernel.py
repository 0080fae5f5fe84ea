"""ctypes wrapper of the CUDA per-segment top-k (csrc/segment_topk.cu)."""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.kernels import (SM_COUNT, CudaKernel, check_same_cuda,
                                  sm_count)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# the kernel keeps a count and a bucket start per segment in shared
# memory
MAX_SEGMENTS = 2048
# the reference kernel's envelope
MAX_K = 16
THREADS = 1024           # stage 1's block (csrc: TOPK_THREADS)
PASS_ROWS = 8 * THREADS  # rows a block buckets at once, 8 a thread
SPLIT_ROWS = 2048        # past one block: at least this many rows a block
MAX_BLOCKS = 256         # stage 2: 2 lists on each of 128 threads

KERNEL = CudaKernel(
    "segment_topk",
    Path(__file__).parent / "csrc" / "segment_topk.cu",
    {"segment_topk": (_P, _P, _L, _I, _I, _I, _L, _P, _P, _P)})


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One call's launch plan: ``blocks`` stage-1 blocks of THREADS
    threads and ``rows_per_block`` rows each (the last one shorter), taken
    in ``passes`` passes of up to PASS_ROWS; ``smem_bytes`` of shared
    memory for stage 1 and ``merge_smem_bytes`` for stage 2; a scratch of
    ``scratch_bytes`` ([S][blocks][k] keys, then [S][blocks] counts); and
    ``launches`` kernels (1 with one block, else 2)."""
    blocks: int
    rows_per_block: int
    passes: int
    smem_bytes: int
    merge_smem_bytes: int
    scratch_bytes: int
    launches: int


def geometry(r: int, s: int, k: int, sms: int = SM_COUNT) -> Geometry:
    """The launch plan for ``r`` > 0 rows, ``s`` segments and top-``k`` on
    a card of ``sms`` SMs: one block, and one launch, up to PASS_ROWS
    rows; past that a block per SPLIT_ROWS rows, at most one per SM (a
    block then takes several passes where its share exceeds PASS_ROWS).
    Shares are a multiple of 4 rows (16-byte loads)."""
    blocks = 1 if r <= PASS_ROWS else max(
        2, min(sms, MAX_BLOCKS, -(-r // SPLIT_ROWS)))
    rows = -(-r // blocks)
    rows = -(-rows // 4) * 4
    blocks = -(-r // rows)
    # the pass's keys and their 16-bit segments, counts, bucket starts
    smem = PASS_ROWS * (8 + 2) + (2 * s + 32) * 4
    one = blocks == 1
    # stage 2: each list's head, and a pool of up to k keys of each list
    return Geometry(blocks, rows, -(-rows // PASS_ROWS), smem,
                    0 if one else blocks * (k + 1) * 8,
                    0 if one else s * blocks * (8 * k + 1),
                    1 if one else 2)


def segment_topk_idx(values: torch.Tensor, seg: torch.Tensor,
                     num_segments: int, k: int) -> torch.Tensor:
    """values: (R,) integer of any width, ranked as the plain version ranks
    them, clipped to [0, 2^31); seg: (R,) integer, rows outside
    [0, num_segments) dropped.  Returns (num_segments, k) int32 row
    indices, -1-filled (value desc, ties by row asc).  The arguments are
    checked before the device: outside the envelope it raises anywhere."""
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
    dev = check_same_cuda(values, seg)
    if values.dtype != torch.int32:
        # the kernel clips negatives itself; wider values saturate at
        # 2^31 - 1 as in the plain version's composite key; out of place,
        # since .long() of an int64 tensor is the caller's own tensor
        values = values.long().clamp(0, 2**31 - 1)
    values = values.to(torch.int32).contiguous()
    seg = seg.to(torch.int32).contiguous()
    out = torch.empty((num_segments, k), dtype=torch.int32, device=dev)
    if r == 0:
        return out.fill_(-1)
    g = geometry(r, num_segments, k,
                 sm_count(dev))
    scratch = (torch.empty(g.scratch_bytes, dtype=torch.uint8, device=dev)
               if g.scratch_bytes else None)
    KERNEL.launch("segment_topk", dev, values.data_ptr(), seg.data_ptr(),
                  r, num_segments, k, g.blocks, g.rows_per_block,
                  None if scratch is None else scratch.data_ptr(),
                  out.data_ptr())
    return out
