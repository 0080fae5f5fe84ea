"""Analytical queries over the enriched column store (the read side the
paper stores enrichments FOR: "stored (and queried) together with the
data" so complex analytical queries can use them, §1/§8).

    result = (store.query()
              .where(col("safety_level") >= 3)
              .group_by("country")
              .agg(total=agg.sum("religious_population"),
                   n=agg.count(),
                   top=agg.topk("religious_population", k=3))
              .execute())

Four properties, in execution order:

  * **Snapshot consistency** — ``execute()`` runs against a pinned
    ``StoreSnapshot``: per partition, the unit list (segments + buffered
    chunks), a copy of the pk index, and the row watermark are captured
    under ONE lock acquisition (``StoragePartition.snapshot_view``).
    Concurrent ingest appends, repair upserts, filter-deletes, and
    compactions land after the watermark or behind retained files — the
    query sees exactly one consistent version of every pk (per-partition
    snapshot isolation; a pk lives in exactly one hash partition, so
    latest-wins is globally exact).
  * **Latest-wins** — superseded row versions accumulate append-only
    (upserts, repairs) until compaction; a scanned row counts only if the
    snapshot's pk index still points at its position.  Deleted pks
    (repair filter-deletes) drop out the same way.
  * **Zone-map pruning** — structured predicates (``col("x") >= 3``,
    combinable with ``&``/``|``/``~``) are interval-checked against each
    segment's persisted per-column min/max BEFORE any IO: a segment the
    predicate provably cannot match is skipped entirely, and surviving
    segments decompress only the referenced + selected columns
    (predicate/column pushdown into the npz member reads).
  * **Kernel-backed aggregation** — group-by aggregates route through the
    enrichment dispatch layer (core/enrich/dispatch.py): ``count`` and
    ``sum`` ride ``dispatch.segment_sum`` (the CUDA segment-sum kernel on
    the card, int32 to float64), ``topk`` rides ``dispatch.segment_topk``
    (the CUDA per-segment top-k kernel on the card).  Group keys map
    to dense segment ids against an incrementally-grown sorted
    dictionary; the segment count is padded to a power-of-two bucket,
    exactly like the write-side operators.  Integer sums are widened to
    int64 first so totals are exact.  By default aggregation is
    **batched** (``execute(batched=True)``): surviving units' masked rows are concatenated in scan
    order (``dispatch.concat_rows``) so the whole query pays one
    dispatch per aggregate instead of one per unit — at 2K-row segments
    that is the difference between launch-overhead-bound and
    compute-bound aggregation.

``QueryStats`` (on every result) reports units scanned vs pruned and row
counts — the observability the fig_query benchmark and the pruning
acceptance criterion read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.storage import StorageJob, PartitionSnapshot, ZoneMap


class QueryError(ValueError):
    """Invalid query, detected before any scan IO."""


# ---------------------------------------------------------------------------
# predicate algebra (zone-map-aware)
# ---------------------------------------------------------------------------

class Predicate:
    """Base class: ``mask(cols)`` evaluates vectorized over a unit's
    columns; ``maybe(zone_map)`` is the pruning test — False means the
    unit PROVABLY contains no matching row (conservative: unknown columns
    or missing zone maps answer True)."""

    def mask(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def maybe(self, zm: ZoneMap) -> bool:
        return True

    @property
    def columns(self) -> Optional[frozenset]:
        """Columns the predicate reads; None = unknown (read everything)."""
        return frozenset()

    def __and__(self, other: "Predicate") -> "Predicate":
        return _And(self, _as_pred(other))

    def __or__(self, other: "Predicate") -> "Predicate":
        return _Or(self, _as_pred(other))

    def __invert__(self) -> "Predicate":
        return _Not(self)


def _as_pred(p) -> Predicate:
    if isinstance(p, Predicate):
        return p
    if callable(p):
        return _Raw(p)
    raise QueryError(f"not a predicate: {p!r} (use col(...) comparisons "
                     "or a callable over the column dict)")


class _Cmp(Predicate):
    _OPS = ("==", "!=", "<", "<=", ">", ">=")

    def __init__(self, name: str, op: str, value):
        assert op in self._OPS
        self.name, self.op, self.value = name, op, value

    def mask(self, cols):
        c, v = cols[self.name], self.value
        return {"==": c == v, "!=": c != v, "<": c < v, "<=": c <= v,
                ">": c > v, ">=": c >= v}[self.op]

    def maybe(self, zm):
        if self.name not in zm:
            return True
        mn, mx = zm[self.name]
        v = self.value
        return {"==": mn <= v <= mx,
                "!=": not (mn == mx == v),
                "<": mn < v, "<=": mn <= v,
                ">": mx > v, ">=": mx >= v}[self.op]

    @property
    def columns(self):
        return frozenset((self.name,))

    def __repr__(self):
        return f"(col({self.name!r}) {self.op} {self.value!r})"


class _IsIn(Predicate):
    def __init__(self, name: str, values: Sequence):
        self.name = name
        self.values = np.asarray(sorted(values))
        if self.values.size == 0:
            raise QueryError("isin() needs at least one value")

    def mask(self, cols):
        return np.isin(cols[self.name], self.values)

    def maybe(self, zm):
        if self.name not in zm:
            return True
        mn, mx = zm[self.name]
        return bool(np.any((self.values >= mn) & (self.values <= mx)))

    @property
    def columns(self):
        return frozenset((self.name,))

    def __repr__(self):
        return f"(col({self.name!r}).isin({self.values.tolist()!r}))"


class _And(Predicate):
    def __init__(self, a: Predicate, b: Predicate):
        self.a, self.b = a, b

    def mask(self, cols):
        return self.a.mask(cols) & self.b.mask(cols)

    def maybe(self, zm):
        return self.a.maybe(zm) and self.b.maybe(zm)

    @property
    def columns(self):
        ca, cb = self.a.columns, self.b.columns
        return None if ca is None or cb is None else ca | cb

    def __repr__(self):
        return f"({self.a!r} & {self.b!r})"


class _Or(_And):
    def mask(self, cols):
        return self.a.mask(cols) | self.b.mask(cols)

    def maybe(self, zm):
        return self.a.maybe(zm) or self.b.maybe(zm)

    def __repr__(self):
        return f"({self.a!r} | {self.b!r})"


class _Not(Predicate):
    # zone maps answer "can [min,max] intersect the predicate's accepting
    # set"; the complement of an interval test is not interval-decidable
    # in general, so ~p never prunes (conservative, always correct)
    def __init__(self, p: Predicate):
        self.p = p

    def mask(self, cols):
        return ~self.p.mask(cols)

    @property
    def columns(self):
        return self.p.columns

    def __repr__(self):
        return f"(~{self.p!r})"


class _Raw(Predicate):
    """An opaque callable over the column dict: no pruning, and every
    stored column is read for it (prefer ``col(...)`` comparisons)."""

    def __init__(self, fn: Callable[[Dict[str, np.ndarray]], np.ndarray]):
        self.fn = fn

    def mask(self, cols):
        out = np.asarray(self.fn(cols))
        if out.dtype != np.bool_:
            raise QueryError("callable predicate must return a bool mask")
        return out

    @property
    def columns(self):
        return None


class ColRef:
    """``col("safety_level") >= 3`` — the builder predicates start from."""

    def __init__(self, name: str):
        self.name = name

    def __eq__(self, v):                                  # type: ignore
        return _Cmp(self.name, "==", v)

    def __ne__(self, v):                                  # type: ignore
        return _Cmp(self.name, "!=", v)

    def __lt__(self, v):
        return _Cmp(self.name, "<", v)

    def __le__(self, v):
        return _Cmp(self.name, "<=", v)

    def __gt__(self, v):
        return _Cmp(self.name, ">", v)

    def __ge__(self, v):
        return _Cmp(self.name, ">=", v)

    def isin(self, values: Sequence):
        return _IsIn(self.name, values)

    def between(self, lo, hi):
        """Inclusive range — the selective-scan idiom zone maps love."""
        return _Cmp(self.name, ">=", lo) & _Cmp(self.name, "<=", hi)

    __hash__ = None


def col(name: str) -> ColRef:
    return ColRef(name)


# ---------------------------------------------------------------------------
# aggregations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AggSpec:
    kind: str                       # sum | count | mean | topk
    column: Optional[str] = None
    k: int = 0
    payload: Optional[str] = None   # topk: column returned (default: id)


class agg:
    """Aggregation constructors for ``Query.agg(name=...)``."""

    @staticmethod
    def sum(column: str) -> AggSpec:                      # noqa: A003
        return AggSpec("sum", column)

    @staticmethod
    def count() -> AggSpec:
        return AggSpec("count")

    @staticmethod
    def mean(column: str) -> AggSpec:
        return AggSpec("mean", column)

    @staticmethod
    def topk(column: str, k: int, payload: str = "id") -> AggSpec:
        """Per group: the ``payload`` values of the ``k`` largest
        ``column`` rows (value desc, ties by scan order), -1-filled.
        ``column`` must be non-negative integers (the segment_topk
        contract shared with the Q3 state builder)."""
        if k < 1:
            raise QueryError(f"topk k must be >= 1, got {k}")
        return AggSpec("topk", column, k=k, payload=payload)


def _bucket_segments(n: int) -> int:
    """Pad the dense group count to a power-of-two bucket (floor 128) —
    the same ladder the probe rows use (and the same code:
    dispatch.bucket_rows)."""
    from repro_torch.core.enrich import dispatch
    return dispatch.bucket_rows(n, minimum=128)


class _GroupedAggregator:
    """Streaming group-by aggregation over scan batches.

    Keys map to dense segment ids against a sorted dictionary that grows
    as new keys appear (accumulators are realigned with bulk
    ``np.insert``).  Per-batch partials run through the kernel dispatch
    layer; host-side accumulation is 64-bit so totals are exact.  ``topk``
    keeps only each batch's per-key winners as candidates (the global
    top-k is a subset of the per-batch top-ks) and merges them in one
    final dispatch call — candidate order preserves scan order, so
    tie-breaking matches a naive full scan exactly."""

    def __init__(self, key_col: Optional[str], aggs: Dict[str, AggSpec],
                 device: Optional[torch.device] = None):
        self.key_col = key_col
        self.device = device if device is not None else torch.device("cpu")
        self.aggs = aggs
        self.batched_units = 0      # units deferred into the one batch
        self.keys = np.empty(0, np.int64)
        self._acc: Dict[str, np.ndarray] = {}
        self._cnt: Dict[str, np.ndarray] = {}
        self._cand: Dict[str, List[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]]] = {}
        self.invocations = 0
        for name, a in aggs.items():
            if a.kind in ("sum", "mean"):
                # int64 until a float partial arrives (then float64): int
                # totals stay exact — bitwise-equal to a naive full scan
                self._acc[name] = np.empty(0, np.int64)
            if a.kind in ("count", "mean"):
                self._cnt[name] = np.empty(0, np.int64)
            if a.kind == "topk":
                self._cand[name] = []

    def columns_needed(self) -> Tuple[str, ...]:
        """Columns ``consume`` reads: the group key plus every
        aggregate's value/payload columns — what the batched path must
        buffer per surviving unit."""
        need = set()
        if self.key_col is not None:
            need.add(self.key_col)
        for a in self.aggs.values():
            if a.column is not None:
                need.add(a.column)
            if a.kind == "topk" and a.payload is not None:
                need.add(a.payload)
        return tuple(sorted(need))

    # ------------------------------------------------------------- consume
    def _dense_ids(self, kv: np.ndarray) -> np.ndarray:
        new = np.setdiff1d(kv, self.keys)   # unique + sorted
        if new.size:
            pos = np.searchsorted(self.keys, new)
            self.keys = np.insert(self.keys, pos, new)
            for d in (self._acc, self._cnt):
                for name in d:
                    d[name] = np.insert(d[name], pos, 0)
        return np.searchsorted(self.keys, kv).astype(np.int32)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def consume(self, cols: Dict[str, np.ndarray], mask: np.ndarray
                ) -> None:
        from repro_torch.core.enrich import dispatch

        if not mask.any():
            return
        if self.key_col is None:
            kv = np.zeros(int(mask.sum()), np.int64)
        else:
            kv = np.asarray(cols[self.key_col][mask])
            if kv.ndim != 1:
                raise QueryError(
                    f"group_by column {self.key_col!r} must be 1-D")
            kv = kv.astype(np.int64)
        seg = self._dense_ids(kv)
        nseg = int(self.keys.shape[0])
        nseg_b = _bucket_segments(nseg)
        # pad rows to a power-of-two bucket with overflow-segment rows
        # (dropped on every path), so the dispatch layer sees a bounded
        # set of shapes — the write side's bucket ladder
        n = int(kv.shape[0])
        nb = dispatch.bucket_rows(n)
        seg_p = np.full(nb, nseg_b, np.int32)
        seg_p[:n] = seg
        seg_j = self._put(seg_p)

        def padded(v, dtype):
            out = np.zeros(nb, dtype)
            out[:n] = v
            return self._put(out)

        counted = False
        for name, a in self.aggs.items():
            if a.kind in ("count", "mean") and not counted:
                cnt = dispatch.segment_count(seg_j, nseg_b).cpu().numpy(
                )[:nseg].astype(np.int64)
                self.invocations += 1
                counted = True
            if a.kind == "count":
                self._cnt[name] += cnt
            elif a.kind in ("sum", "mean"):
                v = np.asarray(cols[a.column][mask])
                wide = (np.int64 if np.issubdtype(v.dtype, np.integer)
                        or v.dtype == np.bool_ else np.float64)
                part = dispatch.segment_sum(
                    padded(v, wide), seg_j, nseg_b).cpu().numpy()[:nseg]
                self.invocations += 1
                acc = self._acc[name]
                if np.issubdtype(part.dtype, np.floating) and \
                        acc.dtype != np.float64:
                    acc = acc.astype(np.float64)
                self._acc[name] = acc + part
                if a.kind == "mean":
                    self._cnt[name] += cnt
            elif a.kind == "topk":
                v = np.asarray(cols[a.column][mask])
                if not (np.issubdtype(v.dtype, np.integer)
                        or v.dtype == np.bool_):
                    raise QueryError(
                        f"topk column {a.column!r} must be integer "
                        f"(dtype {v.dtype}): ranking follows the "
                        "segment_topk integer-composite contract")
                if v.size and int(v.max()) > np.iinfo(np.int32).max:
                    # BOTH segment_topk paths rank within [0, 2^31):
                    # the reference's composite key saturates there and
                    # the kernel's winner table is int32 — wide values
                    # would silently tie at the top, so fail loudly
                    raise QueryError(
                        f"topk column {a.column!r} holds values above "
                        "int32 range; segment_topk ranks within "
                        "[0, 2^31) (negatives rank as 0)")
                # keep the native width: the kernel's wrapper clips
                # 64-bit values to [0, 2^31) as the plain version does,
                # never through an int32 wrap
                v = v.astype(np.int32) if v.dtype == np.bool_ else v
                pay = np.asarray(cols[a.payload][mask])
                kidx = self._put(np.arange(nb, dtype=np.int64))
                pidx, _ = dispatch.segment_topk(
                    padded(v, v.dtype), seg_j, kidx, nseg_b, a.k)
                self.invocations += 1
                pidx = pidx.cpu().numpy()[:nseg]        # (nseg, k) into kidx
                sel = pidx[pidx >= 0]
                # candidates in scan order: rows within the batch ascend
                order = np.sort(sel)
                self._cand[name].append(
                    (self.keys[seg[order]], v[order], pay[order]))

    # -------------------------------------------------------------- finish
    def finish(self) -> Dict[str, np.ndarray]:
        from repro_torch.core.enrich import dispatch

        out: Dict[str, np.ndarray] = {}
        nseg = int(self.keys.shape[0])
        if self.key_col is not None:
            out[self.key_col] = self.keys.copy()
        for name, a in self.aggs.items():
            if a.kind == "count":
                out[name] = self._cnt[name].copy()
            elif a.kind == "sum":
                out[name] = self._acc[name].copy()
            elif a.kind == "mean":
                with np.errstate(invalid="ignore"):
                    out[name] = self._acc[name] / self._cnt[name]
            elif a.kind == "topk":
                cands = self._cand[name]
                if nseg == 0 or not cands:
                    out[name] = np.full((nseg, a.k), -1)
                    continue
                ck = np.concatenate([c[0] for c in cands])
                cv = np.concatenate([c[1] for c in cands])
                cp = np.concatenate([c[2] for c in cands])
                seg = np.searchsorted(self.keys, ck).astype(np.int32)
                nseg_b = _bucket_segments(nseg)
                n = int(cv.shape[0])
                nb = dispatch.bucket_rows(n)
                seg_p = np.full(nb, nseg_b, np.int32)
                seg_p[:n] = seg
                cv_p = np.zeros(nb, cv.dtype)
                cv_p[:n] = cv
                cp_p = np.zeros(nb, cp.dtype)
                cp_p[:n] = cp
                pay, _ = dispatch.segment_topk(
                    self._put(cv_p), self._put(seg_p),
                    self._put(cp_p), nseg_b, a.k)
                self.invocations += 1
                out[name] = pay.cpu().numpy()[:nseg]
        return out


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

class StoreSnapshot:
    """Pinned consistent view across every partition of a ``StorageJob``.
    Each partition is internally consistent (units + index + watermark
    from one lock hold); a pk hashes to exactly one partition, so
    latest-wins semantics are globally exact."""

    def __init__(self, storage: StorageJob):
        self.parts: List[PartitionSnapshot] = []
        try:
            for p in storage.partitions:
                self.parts.append(p.snapshot_view())
        except BaseException:
            self.close()
            raise

    @property
    def watermark(self) -> int:
        """Total row versions visible (sum of partition watermarks)."""
        return sum(ps.watermark for ps in self.parts)

    @property
    def live_rows(self) -> int:
        return sum(ps.live_rows for ps in self.parts)

    def close(self) -> None:
        for ps in self.parts:
            ps.release()

    def __enter__(self) -> "StoreSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the query builder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueryStats:
    units: int = 0               # scannable units in the snapshot
    units_pruned: int = 0        # skipped via zone maps (no IO at all)
    segments: int = 0            # flushed-segment units among `units`
    segments_pruned: int = 0
    rows_scanned: int = 0        # rows of units actually read
    rows_live: int = 0           # after latest-wins
    rows_matched: int = 0        # after the predicate
    agg_invocations: int = 0     # dispatch-layer kernel calls
    agg_batched_units: int = 0   # units folded into the one-dispatch batch
    # execution-path split of the aggregate dispatches (the per-thread
    # path tape of repro_torch.kernels): kernel vs plain version; the port
    # has no wide-dtype fallback, so agg_64bit_fallbacks stays 0
    agg_kernel_dispatches: int = 0
    agg_fallback_dispatches: int = 0
    agg_64bit_fallbacks: int = 0
    wall_s: float = 0.0


class QueryResult(dict):
    """Column dict (numpy arrays) + ``stats``; group-by results are keyed
    by the group column (ascending) + one entry per aggregate."""

    def __init__(self, columns: Dict[str, np.ndarray], stats: QueryStats,
                 snapshot_watermark: int):
        super().__init__(columns)
        self.stats = stats
        self.watermark = snapshot_watermark

    @property
    def rows(self) -> int:
        for v in self.values():
            return int(v.shape[0])
        return 0


class Query:
    """Composable analytical query over a ``StorageJob`` — build with
    ``where``/``select``/``group_by``/``agg``, run with ``execute()``."""

    def __init__(self, storage: StorageJob):
        self._storage = storage
        self._pred: Optional[Predicate] = None
        self._select: Optional[Tuple[str, ...]] = None
        self._group: Optional[str] = None
        self._aggs: Dict[str, AggSpec] = {}

    # ------------------------------------------------------------- builders
    def where(self, *preds) -> "Query":
        """AND-combine predicates (``col(...)`` comparisons or callables
        over the column dict; only the former can prune segments)."""
        if not preds:
            raise QueryError("where() needs at least one predicate")
        for p in preds:
            p = _as_pred(p)
            self._pred = p if self._pred is None else (self._pred & p)
        return self

    def select(self, *cols: str) -> "Query":
        if not cols:
            raise QueryError("select() needs at least one column")
        self._select = tuple(dict.fromkeys(cols))
        return self

    def group_by(self, column: str) -> "Query":
        if self._group is not None:
            raise QueryError("group_by() may appear at most once")
        self._group = column
        return self

    def agg(self, **aggs: AggSpec) -> "Query":
        for name, a in aggs.items():
            if not isinstance(a, AggSpec):
                raise QueryError(
                    f"agg {name}={a!r}: use agg.sum/count/mean/topk")
        self._aggs.update(aggs)
        return self

    # -------------------------------------------------------------- execute
    def _needed_columns(self) -> Optional[Tuple[str, ...]]:
        """Columns the scan must materialize; None = all (opaque
        predicate).  'id' always rides along (latest-wins needs it)."""
        pred_cols = self._pred.columns if self._pred is not None \
            else frozenset()
        if pred_cols is None:
            return None
        need = {"id"} | set(pred_cols)
        if self._aggs:
            if self._group is not None:
                need.add(self._group)
            for a in self._aggs.values():
                if a.column is not None:
                    need.add(a.column)
                if a.payload is not None:
                    need.add(a.payload)
        elif self._select is not None:
            need |= set(self._select)
        else:
            return None                       # plain scan: all columns
        return tuple(need)

    def execute(self, prune: bool = True,
                snapshot: Optional[StoreSnapshot] = None,
                batched: bool = True) -> QueryResult:
        """Run the query.  ``prune=False`` disables zone-map pruning (the
        benchmark's A/B axis — results must be identical).  ``batched``
        (default) defers aggregation: surviving units' masked rows are
        concatenated in scan order (``dispatch.concat_rows``) and the
        whole query pays ONE ``segment_*`` dispatch per aggregate instead
        of one per unit — results are identical either way (int sums are
        64-bit exact and order-free, top-k tie-breaking is scan-order on
        both paths).  Passing a ``snapshot`` runs against a view taken
        earlier (the caller keeps ownership and must ``close()`` it);
        otherwise a fresh snapshot is pinned for exactly this
        execution."""
        if self._group is not None and not self._aggs:
            raise QueryError("group_by() without agg(): add at least one "
                             "aggregate (agg.count() counts group sizes)")
        if self._aggs and self._select is not None:
            raise QueryError("select() and agg() are mutually exclusive: "
                             "aggregates define the output columns")
        from repro_torch import kernels
        from repro_torch.core.enrich import dispatch
        t0 = time.perf_counter()
        stats = QueryStats()
        own = snapshot is None
        snap = StoreSnapshot(self._storage) if own else snapshot
        tape = bool(self._aggs)
        if tape:
            kernels.path_tape_start()
        try:
            need = self._needed_columns()
            gagg = _GroupedAggregator(
                self._group, self._aggs,
                resolve_device(getattr(self._storage, "device", None))) \
                if self._aggs else None
            # batched-agg: per-unit masked slices of the columns consume
            # reads (at least one column so the row count survives even
            # a bare count() with no group key)
            agg_cols = (gagg.columns_needed() or ("id",)) \
                if gagg is not None else ()
            pending: List[Dict[str, np.ndarray]] = []
            scanned: Dict[str, List[np.ndarray]] = {}
            sel_cols: Optional[Tuple[str, ...]] = None
            # per-unit read tally (segment path or chunk tag), kept local
            # through the scan and published ONCE afterwards — the hot
            # loop never touches the store-stats lock
            reads: Dict[Tuple[int, str], int] = {}
            for ps in snap.parts:
                for unit in ps.units:
                    is_seg = unit.path is not None
                    stats.units += 1
                    stats.segments += int(is_seg)
                    if unit.rows == 0:
                        continue
                    if prune and self._pred is not None and \
                            unit.zone_map is not None and \
                            not self._pred.maybe(unit.zone_map):
                        stats.units_pruned += 1
                        stats.segments_pruned += int(is_seg)
                        continue
                    cols = unit.read(need)
                    tag = (unit.path if unit.path is not None
                           else f"chunk@{unit.base}")
                    key = (ps.pid, tag)
                    reads[key] = reads.get(key, 0) + 1
                    stats.rows_scanned += unit.rows
                    m = ps.live_mask(cols["id"], unit.base)
                    stats.rows_live += int(m.sum())
                    if self._pred is not None:
                        m = m & self._pred.mask(cols)
                    stats.rows_matched += int(m.sum())
                    if gagg is not None:
                        if batched:
                            if m.any():
                                pending.append(
                                    {k: np.asarray(cols[k])[m]
                                     for k in agg_cols})
                                stats.agg_batched_units += 1
                        else:
                            gagg.consume(cols, m)
                        continue
                    if sel_cols is None:
                        sel_cols = self._select if self._select is not None \
                            else tuple(cols)
                    for k in sel_cols:
                        if k not in cols:
                            raise QueryError(
                                f"unknown column {k!r}; stored columns: "
                                f"{sorted(cols)}")
                        scanned.setdefault(k, []).append(
                            np.asarray(cols[k])[m])
            if gagg is not None:
                if pending:
                    joined, n = dispatch.concat_rows(pending)
                    gagg.consume(joined, np.ones(n, bool))
                out = gagg.finish()
                stats.agg_invocations = gagg.invocations
            elif sel_cols is None:       # empty store
                out = {k: np.empty(0) for k in (self._select or ())}
            else:
                out = {k: np.concatenate(scanned[k]) if scanned[k]
                       else np.empty(0) for k in sel_cols}
            if tape:
                tape = False
                paths = kernels.path_tape_stop()
                for (_op, path), c in paths.items():
                    if path == "kernel":
                        stats.agg_kernel_dispatches += c
                    else:
                        stats.agg_fallback_dispatches += c
                        if path == "xla_64bit":
                            stats.agg_64bit_fallbacks += c
            if reads:
                self._storage.note_unit_reads(reads.items())
            stats.wall_s = time.perf_counter() - t0
            return QueryResult(out, stats, snap.watermark)
        finally:
            if tape:
                kernels.path_tape_stop()
            if own:
                snap.close()
