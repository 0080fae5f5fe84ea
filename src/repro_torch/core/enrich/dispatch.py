"""Enrichment kernel-dispatch layer: route the relational operators to the
hand-written CUDA kernels.

The paper's thesis (An IDEA §6-8) only pays off if the enrichment operators
themselves are fast at scale.  This module is the one place that decides
which body runs:

  * **Routing is by device.**  A CUDA tensor goes to the hand kernel
    (kernels/hash_probe, kernels/spatial_join, kernels/segment_reduce),
    which launches or raises.  A CPU or ``meta`` tensor (plan validation)
    goes to the kernel's plain PyTorch version.  There is no mode switch
    and no row threshold: a batch of 512 keys on the card still runs the
    kernel.  The plain versions use the kernels' own arithmetic
    (d2 = dx*dx + dy*dy for the spatial join), so the card and the CPU
    give the same bits for every integer and index output.

  * **Bucket bookkeeping.**  ``bucket_rows`` is the power-of-two ladder the
    computing runner pads coalesced batches to and the query layer pads
    its segment counts to.  Every kernel dispatch records its row bucket
    in ``bucket_stats()`` (PyTorch runs eagerly, so the kernels take the
    unpadded rows; the bucket keeps the reference's accounting).

``segment_topk`` has no kernel on the card yet (ROADMAP, Queue 2):
inside its envelope a CUDA tensor raises ``NotImplementedError``; outside
it (Q3's 50K-segment state build) every device takes the composite-key
sort, as the reference does.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.hash_probe import ops as hp_ops
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.kernels.segment_topk import ops as st_ops
from repro_torch.kernels.spatial_join import ops as sj_ops

Array = torch.Tensor


@dataclasses.dataclass
class DispatchConfig:
    bucket_min: int = 512         # smallest probe bucket
    bucket_max: int = 1 << 22     # cap: beyond this, chunk upstream
    # segment_topk kernel envelope (the reference's): at most this many
    # segments and this k; outside it the composite-key sort runs
    topk_max_segments: int = 2048
    topk_max_k: int = 16


_config = DispatchConfig()
_stats_lock = threading.Lock()              # lock-name: dispatch-stats
_bucket_hits: Dict[Tuple[str, int], int] = {}   # guarded-by: _stats_lock
# (op, path) execution-path counters for the segment_* aggregation ops:
# "kernel" = the hand kernel on the card, "reference" = the plain version
# (CPU/meta tensors, or segment_topk outside its envelope).  Callers that
# need a per-query view (QueryStats' kernel-vs-fallback report) use the
# thread-local tape.
_path_hits: Dict[Tuple[str, str], int] = {}     # guarded-by: _stats_lock
_tls = threading.local()                    # per-thread path tape


def bucket_rows(n: int, minimum: Optional[int] = None) -> int:
    """Smallest power-of-two bucket >= n (floor ``minimum``)."""
    lo = max(int(minimum) if minimum is not None else _config.bucket_min, 1)
    b = lo
    while b < n:
        b <<= 1
    return min(max(b, n), max(_config.bucket_max, n))


def bucket_stats() -> Dict[Tuple[str, int], int]:
    """(op, bucket) -> kernel dispatch count."""
    with _stats_lock:
        return dict(_bucket_hits)


def reset_bucket_stats() -> None:
    with _stats_lock:
        _bucket_hits.clear()


def _note(op: str, bucket: int) -> None:
    with _stats_lock:
        _bucket_hits[(op, bucket)] = _bucket_hits.get((op, bucket), 0) + 1


def path_stats() -> Dict[Tuple[str, str], int]:
    """(op, path) -> dispatch count for the segment_* aggregation ops;
    path is "kernel" or "reference"."""
    with _stats_lock:
        return dict(_path_hits)


def reset_path_stats() -> None:
    with _stats_lock:
        _path_hits.clear()


def path_tape_start() -> None:
    """Start recording this thread's segment_* dispatch paths."""
    _tls.paths = {}


def path_tape_stop() -> Dict[Tuple[str, str], int]:
    """Stop this thread's tape and return its (op, path) counts."""
    d = getattr(_tls, "paths", None) or {}
    _tls.paths = None
    return d


def _note_path(op: str, path: str) -> None:
    with _stats_lock:
        _path_hits[(op, path)] = _path_hits.get((op, path), 0) + 1
    d = getattr(_tls, "paths", None)
    if d is not None:
        d[(op, path)] = d.get((op, path), 0) + 1


# ---------------------------------------------------------------------------
# hash join probe
# ---------------------------------------------------------------------------

def sorted_join(probe: Array, ref_keys: Array) -> Tuple[Array, Array]:
    """Equi-join probe against a sorted sentinel-padded key column.
    Returns (idx (B,) int32 [-1 when absent], found (B,) bool)."""
    if on_cuda(probe):
        _note("sorted_join", bucket_rows(probe.shape[0]))
    return hp_ops.sorted_probe(probe.to(torch.int64), ref_keys)


# ---------------------------------------------------------------------------
# spatial radius join
# ---------------------------------------------------------------------------

def radius_topk(points: Array, refs: Array, radius: float, k: int,
                ref_valid: Optional[Array] = None,
                chunk: Optional[int] = None
                ) -> Tuple[Array, Array, Array]:
    """k nearest reference points within ``radius`` per probe point.
    Returns (idx (B,k) int32 [-1], dist2 (B,k) [inf], count (B,)).
    ``chunk`` only shapes the plain version's probe-row blocking."""
    if on_cuda(points):
        _note("radius_topk", bucket_rows(points.shape[0]))
        p = points.to(torch.float32)
        r = refs.to(torch.float32)
        return sj_ops.radius_join(p[:, 0], p[:, 1], r[:, 0], r[:, 1],
                                  radius, k, ref_valid)
    from repro_torch.core.enrich import ops
    kw = {} if chunk is None else {"chunk": chunk}
    return ops._radius_topk_ref(points, refs, radius, k, ref_valid, **kw)


def radius_count(points: Array, refs: Array, radius: float,
                 ref_valid: Optional[Array] = None,
                 chunk: Optional[int] = None) -> Array:
    """#reference points within ``radius`` of each probe point, (B,) int32:
    the radius join's count output with a minimal top-k."""
    if on_cuda(points):
        _note("radius_count", bucket_rows(points.shape[0]))
        p = points.to(torch.float32)
        r = refs.to(torch.float32)
        return sj_ops.radius_join(p[:, 0], p[:, 1], r[:, 0], r[:, 1],
                                  radius, 1, ref_valid)[2]
    from repro_torch.core.enrich import ops
    kw = {} if chunk is None else {"chunk": chunk}
    return ops._radius_count_ref(points, refs, radius, ref_valid, **kw)


# ---------------------------------------------------------------------------
# group-by aggregation
# ---------------------------------------------------------------------------

def segment_sum(values: Array, seg: Array, num_segments: int,
                valid: Optional[Array] = None) -> Array:
    """Group-by sum; int32, int64, float32 and float64 all take the kernel
    on the card (64-bit atomics), so there is no wide-dtype fallback."""
    if not on_cuda(values):
        _note_path("segment_sum", "reference")
        from repro_torch.core.enrich import ops
        return ops._segment_sum_ref(values, seg, num_segments, valid)
    _note_path("segment_sum", "kernel")
    _note("segment_sum", bucket_rows(values.shape[0]))
    seg = seg.to(torch.int32)
    if valid is not None:
        # invalid rows route to the dropped overflow segment
        seg = torch.where(valid, seg, num_segments)
    return sr_ops.segment_sum(values, seg, num_segments)


def segment_count(seg: Array, num_segments: int,
                  valid: Optional[Array] = None) -> Array:
    ones = torch.ones(seg.shape, dtype=torch.int32, device=seg.device)
    return segment_sum(ones, seg, num_segments, valid)


def segment_topk(values: Array, seg: Array, payload: Array,
                 num_segments: int, k: int,
                 valid: Optional[Array] = None) -> Tuple[Array, Array]:
    """Per-segment top-k by ``values`` desc (ties: row asc), returning
    ((S, k) payload -1-filled, (S, k) values 0-filled).  Inside the kernel
    envelope (S <= topk_max_segments, k <= topk_max_k, signed values of at
    most 32 bits) a CUDA tensor goes to ``kernels/segment_topk``, which
    raises until its kernel is ported; everything else takes the
    composite-key sort."""
    r = values.shape[0]
    in_envelope = (r > 0 and 1 <= num_segments <= _config.topk_max_segments
                   and k <= _config.topk_max_k
                   and values.dtype in (torch.int8, torch.int16,
                                        torch.int32))
    if in_envelope and on_cuda(values):
        # raises NotImplementedError until the kernel is ported
        st_ops.segment_topk_idx(values, seg, num_segments, k)
    _note_path("segment_topk", "reference")
    from repro_torch.core.enrich import ops
    return ops._segment_topk_ref(values, seg, payload, num_segments, k,
                                 valid)


# ---------------------------------------------------------------------------
# batched-aggregation planner
# ---------------------------------------------------------------------------

def concat_rows(parts: Sequence[Dict[str, np.ndarray]]
                ) -> Tuple[Dict[str, np.ndarray], int]:
    """Concat planner for the per-query batched aggregation path
    (core/query.py): the per-unit masked column slices of one query are
    concatenated IN SCAN ORDER into a single contiguous batch per column,
    so the whole query pays one ``segment_*`` dispatch per aggregate
    instead of one per surviving unit.  Returns ``(cols, n)`` with ``n``
    real rows; the caller pads row dimensions to ``bucket_rows(n)`` when
    it builds the segment-id vector (padding rows route to the dropped
    overflow segment, which only the caller can number).  Scan order is
    preserved because downstream top-k tie-breaking is
    value-desc-then-scan-order."""
    parts = [p for p in parts if p and next(iter(p.values())).shape[0]]
    if not parts:
        return {}, 0
    if len(parts) == 1:
        cols = {k: np.asarray(v) for k, v in parts[0].items()}
    else:
        cols = {k: np.concatenate([np.asarray(p[k]) for p in parts])
                for k in parts[0]}
    n = int(next(iter(cols.values())).shape[0])
    _note("concat_rows", bucket_rows(n))
    return cols, n
