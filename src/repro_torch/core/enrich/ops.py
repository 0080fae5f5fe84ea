"""Relational enrichment operators in PyTorch (static shapes, no
data-dependent control flow, so each also runs on ``meta`` tensors for
plan validation).  These are the building blocks of the paper's UDF
workload:

  hash join      -> ``sorted_join``: binary-search probe of the snapshot's
                    sorted key column (kernels/hash_probe on the card)
  group-by       -> ``segment_sum`` / ``segment_count``
                    (kernels/segment_reduce on the card)
  order-by/top-k -> ``segment_topk``: one composite-key sort
  spatial join   -> ``radius_count`` / ``radius_topk``: d2 = dx*dx + dy*dy
                    against every reference point (kernels/spatial_join)
  contains()     -> ``contains_any``: hashed-token membership

Invalid reference rows are key-sentinel padded, so every operator is correct
on fixed-capacity snapshots regardless of fill level.

Routing: the hot-path operators are thin wrappers over the dispatch layer
(dispatch.py), which sends CUDA tensors to the hand kernels and CPU or
meta tensors to the plain versions.  ``pairwise_dist2`` keeps the
|a|^2 + |b|^2 - 2ab identity for ``group_count_within_radius``, which is
plain tensor code on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Array = torch.Tensor

_SPATIAL_CHUNK = 512   # probe-row block for distance tiles (see kernels/)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def sorted_join(probe: Array, ref_keys: Array) -> Tuple[Array, Array]:
    """Equi-join probe: for each probe key, the index of its match in the
    (ascending, sentinel-padded) reference key column and a found flag.
    probe: (B,) int64; ref_keys: (R,) int64 sorted.
    Returns (idx (B,) int32 [-1 when absent], found (B,) bool)."""
    from repro_torch.core.enrich import dispatch
    return dispatch.sorted_join(probe, ref_keys)


def _sorted_join_ref(probe: Array, ref_keys: Array) -> Tuple[Array, Array]:
    from repro_torch.kernels.hash_probe import ref
    return ref.sorted_probe(probe, ref_keys)


def take(col: Array, idx: Array) -> Array:
    """Row gather that tolerates the -1 'absent' index (clamped to row 0;
    callers mask those rows)."""
    return torch.index_select(col, 0, torch.clamp(idx, min=0).reshape(-1)
                              ).reshape(idx.shape + col.shape[1:])


def gather_col(col: Array, idx: Array, found: Array, fill=0) -> Array:
    """Payload gather for an (idx, found) join result."""
    out = take(col, idx)
    # the fill takes the column's dtype (a Python scalar of the same kind
    # never promotes the result)
    fill = float(fill) if out.dtype.is_floating_point else int(fill)
    return torch.where(
        found.reshape(found.shape + (1,) * (out.dim() - 1)), out, fill)


# ---------------------------------------------------------------------------
# group-by aggregation
# ---------------------------------------------------------------------------

def segment_sum(values: Array, seg: Array, num_segments: int,
                valid: Optional[Array] = None) -> Array:
    from repro_torch.core.enrich import dispatch
    return dispatch.segment_sum(values, seg, num_segments, valid)


def _segment_sum_ref(values: Array, seg: Array, num_segments: int,
                     valid: Optional[Array] = None) -> Array:
    from repro_torch.kernels.segment_reduce import ref
    if valid is not None:
        values = torch.where(valid, values, 0)
    return ref.segment_sum(values, seg, num_segments)


def segment_count(seg: Array, num_segments: int,
                  valid: Optional[Array] = None) -> Array:
    from repro_torch.core.enrich import dispatch
    return dispatch.segment_count(seg, num_segments, valid)


def segment_topk(values: Array, seg: Array, payload: Array,
                 num_segments: int, k: int,
                 valid: Optional[Array] = None) -> Tuple[Array, Array]:
    from repro_torch.core.enrich import dispatch
    return dispatch.segment_topk(values, seg, payload, num_segments, k,
                                 valid)


def _segment_topk_ref(values: Array, seg: Array, payload: Array,
                      num_segments: int, k: int,
                      valid: Optional[Array] = None) -> Tuple[Array, Array]:
    """Per-segment top-k by ``values`` (descending), returning the payload.

    One composite-key stable sort — O(R log R), never materializes (S, R).
    values: (R,) non-negative int; seg: (R,) int; payload: (R,) any.
    Returns (payload (S, k) with -1 fill, values (S, k) with 0 fill)."""
    r = values.shape[0]
    dev = values.device
    vmax = 1 << 31
    v = torch.clamp(values.to(torch.int64), 0, vmax - 1)
    segi = seg.to(torch.int64)
    if valid is not None:
        # invalid rows sort to a virtual overflow segment
        segi = torch.where(valid, segi, num_segments)
    composite = segi * vmax + (vmax - 1 - v)   # asc seg, desc value
    order = torch.sort(composite, stable=True).indices
    sseg = segi[order]
    sval = values[order]
    spay = payload[order]
    starts = torch.searchsorted(
        sseg, torch.arange(num_segments + 1, dtype=torch.int64, device=dev))
    pos = torch.arange(r, device=dev) - starts[torch.clamp(
        sseg, 0, num_segments)]
    keep = (pos < k) & (sseg < num_segments)
    # out-of-range slots (overflow segment, negative ids) land in one
    # extra slot that is cut off, like the reference's mode="drop"
    slot = torch.where(keep, sseg * k + pos, num_segments * k)
    pay_out = torch.full((num_segments * k + 1,), -1, dtype=payload.dtype,
                         device=dev)
    val_out = torch.zeros((num_segments * k + 1,), dtype=values.dtype,
                          device=dev)
    pay_out.scatter_(0, slot, torch.where(keep, spay, -1).to(payload.dtype))
    val_out.scatter_(0, slot, torch.where(keep, sval, 0).to(values.dtype))
    return (pay_out[:-1].reshape(num_segments, k),
            val_out[:-1].reshape(num_segments, k))


# ---------------------------------------------------------------------------
# text membership (the ``contains`` adaptation)
# ---------------------------------------------------------------------------

def contains_any(text_tokens: Array, keywords: Array,
                 kw_valid: Optional[Array] = None) -> Array:
    """(B, T) int64 token hashes vs (K,) keyword hashes -> (B,) bool."""
    eq = text_tokens[:, :, None] == keywords[None, None, :]
    if kw_valid is not None:
        eq &= kw_valid[None, None, :]
    eq &= text_tokens[:, :, None] != 0
    return torch.any(eq.flatten(1), dim=1)


# ---------------------------------------------------------------------------
# spatial operators
# ---------------------------------------------------------------------------

def country_keyword_match(text_tokens: Array, country: Array,
                          ref_country: Array, ref_word: Array,
                          ref_valid: Optional[Array] = None,
                          chunk: int = 256) -> Array:
    """SQL++ UDF 2 (tweetSafetyCheck): EXISTS(SELECT s FROM SensitiveWords s
    WHERE t.country = s.country AND contains(t.text, s.word)).
    text_tokens: (B, T); country: (B,); ref_country/ref_word: (R,).
    Returns (B,) bool.  Chunked over probe rows like the spatial tiles."""
    def one(toks, ctry):
        cmatch = ctry[:, None] == ref_country[None, :]           # (b, R)
        wmatch = torch.any(
            (toks[:, :, None] == ref_word[None, None, :])
            & (toks[:, :, None] != 0), dim=1)                    # (b, R)
        hit = cmatch & wmatch
        if ref_valid is not None:
            hit &= ref_valid[None, :]
        return torch.any(hit, dim=1)

    b = text_tokens.shape[0]
    return torch.cat([one(text_tokens[s:s + chunk], country[s:s + chunk])
                      for s in range(0, max(b, 1), chunk)])


def _cross(p: Array, r: Array) -> Array:
    """p @ r.T for K = 2.  On the card the two products are written out
    (x·x' rounded, then y·y' added by one fused multiply-add, as the CPU's
    GEMM adds them): cuBLAS would read the process-wide TF32 flag, and
    under TF32 the inputs lose 13 bits, which flips hits near r²."""
    if p.is_cuda:
        return torch.addcmul(p[:, :1] * r[:, 0][None, :], p[:, 1:],
                             r[:, 1][None, :])
    return p @ r.T


def pairwise_dist2(points: Array, refs: Array) -> Array:
    """Squared euclidean distance matrix via the |a|^2+|b|^2-2ab identity.
    points: (B, 2); refs: (R, 2) -> (B, R) float32."""
    p = points.to(torch.float32)
    r = refs.to(torch.float32)
    d2 = (torch.sum(p * p, dim=1)[:, None]
          + torch.sum(r * r, dim=1)[None, :]
          - 2.0 * _cross(p, r))
    return torch.clamp(d2, min=0.0)


def _chunk_map(fn, points: Array, chunk: int):
    """Apply ``fn`` over probe-row blocks so the (B, R) tile never exceeds
    (chunk, R), concatenating the per-block results."""
    b = points.shape[0]
    if b <= chunk:
        return fn(points)
    outs = [fn(points[s:s + chunk]) for s in range(0, b, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def radius_count(points: Array, refs: Array, radius: float,
                 ref_valid: Optional[Array] = None,
                 chunk: int = _SPATIAL_CHUNK) -> Array:
    """#reference points within ``radius`` of each probe point. (B,) int32."""
    from repro_torch.core.enrich import dispatch
    return dispatch.radius_count(points, refs, radius, ref_valid,
                                 chunk=chunk)


def _radius_count_ref(points: Array, refs: Array, radius: float,
                      ref_valid: Optional[Array] = None,
                      chunk: int = _SPATIAL_CHUNK) -> Array:
    return _radius_topk_ref(points, refs, radius, 1, ref_valid, chunk)[2]


def radius_topk(points: Array, refs: Array, radius: float, k: int,
                ref_valid: Optional[Array] = None,
                chunk: int = _SPATIAL_CHUNK
                ) -> Tuple[Array, Array, Array]:
    """k nearest reference points within ``radius``.
    Returns (idx (B,k) int32 [-1 when absent], dist2 (B,k), count (B,))."""
    from repro_torch.core.enrich import dispatch
    return dispatch.radius_topk(points, refs, radius, k, ref_valid,
                                chunk=chunk)


def _radius_topk_ref(points: Array, refs: Array, radius: float, k: int,
                     ref_valid: Optional[Array] = None,
                     chunk: int = _SPATIAL_CHUNK
                     ) -> Tuple[Array, Array, Array]:
    """The spatial kernel's plain version (d2 = dx*dx + dy*dy, the same
    formula on every device)."""
    from repro_torch.kernels.spatial_join import ref
    p = points.to(torch.float32)
    r = refs.to(torch.float32)
    return ref.radius_join(p[:, 0], p[:, 1], r[:, 0], r[:, 1], radius, k,
                           ref_valid, chunk=chunk)


def group_count_within_radius(points: Array, refs: Array, group: Array,
                              num_groups: int, radius: float,
                              ref_valid: Optional[Array] = None,
                              chunk: int = _SPATIAL_CHUNK) -> Array:
    """Per probe point: counts of in-radius reference points per group
    (Q5/Q6's 'facilities by type').  Returns (B, num_groups) int32.
    The hit x one-hot contraction is a dense matrix product of 0s and 1s,
    exact in TF32 too (every count is below 2^24)."""
    from repro_torch.kernels.spatial_join.ref import radius2
    r2 = radius2(radius)
    onehot = (group[:, None] == torch.arange(
        num_groups, device=group.device)[None, :]).to(torch.float32)
    if ref_valid is not None:
        onehot = onehot * ref_valid[:, None]

    def one(pts):
        d2 = pairwise_dist2(pts, refs)
        hit = (d2 <= r2).to(torch.float32)
        if ref_valid is not None:
            hit = hit * ref_valid[None, :]
        return (hit @ onehot).to(torch.int32)

    return _chunk_map(one, points, chunk)


# points per point_in_rect tile on the card: each tile is ~10 tensor ops,
# and every op is a Python-side launch, so fewer, larger tiles keep Q6's
# 1M-person state build from paying ~1,000 launches (the (tile, R) int32
# temporary is 256 MB at R = 512)
RECT_CHUNK_CUDA = 1 << 17


def point_in_rect(points: Array, rects: Array,
                  rect_valid: Optional[Array] = None,
                  chunk: Optional[int] = None) -> Tuple[Array, Array]:
    """First containing rectangle per point (the paper's district lookup).
    points: (B, 2); rects: (R, 4) [xmin, ymin, xmax, ymax].
    Returns (rect_idx (B,) int32 [-1 when none], found (B,) bool).
    Chunked over points (8192 a tile off the card): Q6 pushes 1M persons
    through this.  The tiling never changes a row's result."""
    if chunk is None:
        chunk = RECT_CHUNK_CUDA if points.device.type == "cuda" else 8192
    big = 2**31 - 1
    iota = torch.arange(rects.shape[0], dtype=torch.int32,
                        device=rects.device)

    def one(pts):
        x, y = pts[:, 0:1], pts[:, 1:2]
        inside = ((x >= rects[None, :, 0]) & (y >= rects[None, :, 1])
                  & (x <= rects[None, :, 2]) & (y <= rects[None, :, 3]))
        if rect_valid is not None:
            inside &= rect_valid[None, :]
        # single min-iota reduction instead of any + argmax
        if inside.shape[1] == 0:
            idx = torch.full((pts.shape[0],), big, dtype=torch.int32,
                             device=pts.device)
        else:
            idx = torch.amin(torch.where(inside, iota[None, :], big), dim=1)
        found = idx != big
        return torch.where(found, idx, -1), found

    return _chunk_map(one, points, chunk)


def time_window_count_by_group(t: Array, event_t: Array, event_group: Array,
                               group_of_interest: Array, window: int,
                               event_valid: Optional[Array] = None) -> Array:
    """Q7: for each (probe time t_i, group g_ij): #events with
    t_i - window < event_t < t_i and event_group == g_ij.
    t: (B,); event_*: (A,); group_of_interest: (B, K). Returns (B, K)."""
    in_window = ((event_t[None, :] < t[:, None])
                 & (event_t[None, :] > (t[:, None] - window)))   # (B, A)
    if event_valid is not None:
        in_window &= event_valid[None, :]
    match = (group_of_interest[:, :, None]
             == event_group[None, None, :])                      # (B, K, A)
    return torch.sum(match & in_window[:, None, :], dim=-1,
                     dtype=torch.int32)
