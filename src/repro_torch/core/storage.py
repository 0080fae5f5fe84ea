"""The storage job (§6.2, §7.2): hash-partition enriched records by primary
key and append them to partitioned column stores.

Idempotence: each partition keeps a primary-key index; re-written keys are
skipped (insert mode) or replace the previous row logically (upsert mode).
With the feed manager's at-least-once batch retry this yields exactly-once
*storage* semantics — the property the hypothesis tests pin down.  The
index is a sorted pair of numpy arrays (pk, latest global row): membership
is one vectorized ``searchsorted`` probe and updates are bulk merges, so
the per-batch insert path has no per-row Python loop.

Durability: partitions buffer columns in memory and flush immutable
``.npz`` segments plus a JSON manifest (atomic rename) when ``spill_dir``
is set — an LSM-flavored, crash-consistent layout; ``recover()`` reloads
manifested segments after a crash.

Read side (core/query.py): at flush every segment records **zone maps**
(per-column min/max, persisted in the manifest, restored by ``recover()``)
so analytical scans can prune segments a predicate provably cannot match;
``sort_key`` optionally sorts each segment's rows at flush (an
ingestion-time layout decision à la INGESTBASE).  ``snapshot_view()``
returns a pinned, consistent view — the unit list, a copy of the pk index,
and the row watermark, captured under one lock — that stays readable (old
segment files are retained) while ingest, repair, and compaction keep
mutating the partition.

Lineage (core/repair.py): every appended chunk — and, after flush, every
segment — records the **reference-version lineage** its rows were enriched
under (``{table: RefTable.version}`` as of the computing job's snapshot).
The manifest persists per-segment lineage so ``recover()`` restores it,
and the repair scheduler compares it against current table versions to
find stale rows.  Repairs are in-place upserts with a conditional index
check (``repair_rows``): a row is only remapped if its index entry still
points at the scanned position, so a concurrent ingest upsert always wins
and re-scans are idempotent — exactly-once repair under live ingestion.

Compaction (core/compaction.py drives it; the primitives live here):
superseded and deleted row versions accumulate append-only — tracked
exactly in per-segment ``dead`` counters — until ``compact_segment`` /
``compact_chunks`` rewrite a unit without them and rebuild its zone maps.
Compaction **renumbers** global row positions (the one operation that
does; sorted flush only permutes within the new segment), so every
partition carries a **layout epoch**, bumped on each renumbering.  In-
flight repair captures the epoch with its unit scan and passes it back as
``expect_epoch`` to ``repair_rows``/``delete_rows``/``update_lineage``:
after a shrink, freed position numbers are reused by later appends, so a
stale conditional check could spuriously match — the epoch check closes
that hole (the rejected unit simply stays stale and is re-scanned).
Pinned snapshot views keep replaced segment files on disk until released.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import nputil
from repro_torch.core.durability import fsync_dir

Lineage = Dict[str, int]          # ref table name -> version enriched under

ZoneMap = Dict[str, Tuple[float, float]]   # column -> (min, max) over a unit


def merge_lineage(lineages: List[Optional[Lineage]]) -> Lineage:
    """Combine chunk lineages into one segment lineage, per-table **min**
    (oldest wins): conservative for staleness — a merged segment is checked
    against the oldest version any of its rows might carry.  A ``None``
    (unversioned) member or a table missing from any member drops the
    table, which the repair scheduler treats as always-stale."""
    if not lineages or any(lin is None for lin in lineages):
        return {}
    tables = set(lineages[0])
    for lin in lineages[1:]:
        tables &= set(lin)
    return {t: min(lin[t] for lin in lineages) for t in tables}


def compute_zone_map(cols: Dict[str, np.ndarray],
                     zone_map_cols: Optional[Tuple[str, ...]]) -> ZoneMap:
    """Per-column (min, max) over a unit's rows — the pruning metadata the
    query subsystem checks predicates against.  ``zone_map_cols=None`` maps
    every eligible column (1-D numeric; bools and tensor columns like
    ``text_tokens`` are not range-prunable); ``()`` disables.  Values are
    plain python numbers so the manifest stays JSON."""
    out: ZoneMap = {}
    for k, v in cols.items():
        if zone_map_cols is not None and k not in zone_map_cols:
            continue
        if v.ndim != 1 or v.shape[0] == 0:
            continue
        if not np.issubdtype(v.dtype, np.number) or v.dtype == np.bool_:
            continue
        if np.issubdtype(v.dtype, np.floating):
            if np.isnan(v).any():
                # NaN breaks interval pruning BOTH ways: min/max become
                # NaN (every maybe() -> False: wrong prunes), and a NaN
                # row satisfies != even when [min,max] is a single point
                # (a nan-ignoring interval would wrongly prune that).
                # No zone map = never pruned = always correct.
                continue
            out[k] = (float(v.min()), float(v.max()))
        else:
            out[k] = (int(v.min()), int(v.max()))
    return out


class _PkIndex:
    """Sorted-array primary-key index: pk -> latest global row.

    Replaces the former dict + per-row Python loops on the hot storage
    path: membership is one ``np.searchsorted`` probe over the batch
    (``nputil.sorted_find``), updates are a bulk in-place overwrite plus
    one ``np.insert`` merge (O(index) memmove in C, amortized fine at
    segment scale)."""

    __slots__ = ("_pks", "_rows")

    def __init__(self):
        self._pks = np.empty(0, np.int64)
        self._rows = np.empty(0, np.int64)

    def __len__(self) -> int:
        return int(self._pks.shape[0])

    def contains(self, ids: np.ndarray) -> np.ndarray:
        return nputil.sorted_find(self._pks,
                                  np.asarray(ids, np.int64))[0]

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Latest global row per id, -1 where absent."""
        ids = np.asarray(ids, np.int64)
        found, loc, _ = nputil.sorted_find(self._pks, ids)
        out = np.full(ids.shape[0], -1, np.int64)
        out[found] = self._rows[loc[found]]
        return out

    def get(self, pk: int) -> Optional[int]:
        row = self.lookup(np.asarray([pk], np.int64))[0]
        return None if row < 0 else int(row)

    def put(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Map each id to its row; within the batch the LAST occurrence
        wins (matches append order: later rows supersede earlier)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        uniq, last = nputil.keep_last(ids)
        rows_u = np.asarray(rows, np.int64)[last]
        found, loc, pos = nputil.sorted_find(self._pks, uniq)
        self._rows[loc[found]] = rows_u[found]
        new = ~found
        if new.any():
            self._pks = np.insert(self._pks, pos[new], uniq[new])
            self._rows = np.insert(self._rows, pos[new], rows_u[new])

    def remove(self, ids: np.ndarray) -> int:
        """Drop entries for ``ids`` (absent ids are ignored)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return 0
        found, loc, _ = nputil.sorted_find(self._pks, ids)
        if not found.any():
            return 0
        drop = np.unique(loc[found])
        self._pks = np.delete(self._pks, drop)
        self._rows = np.delete(self._rows, drop)
        return int(drop.shape[0])

    def remap_span(self, lo: int, hi: int, new_abs: np.ndarray) -> None:
        """Rewrite entries pointing into global rows [lo, hi) through
        ``new_abs`` (old offset -> new absolute row).  Used by sorted flush
        (permutation) and compaction (shrink)."""
        m = (self._rows >= lo) & (self._rows < hi)
        self._rows[m] = new_abs[self._rows[m] - lo]

    def shift_from(self, start: int, delta: int) -> None:
        """Shift every entry at global row >= ``start`` by ``delta``
        (compaction moved the suffix of the position space)."""
        if delta:
            self._rows[self._rows >= start] += delta

    def snapshot_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._pks.copy(), self._rows.copy()


@dataclasses.dataclass(frozen=True)
class SnapshotUnit:
    """One scannable unit of a partition snapshot: a flushed segment (read
    from its immutable file) or a buffered chunk (arrays are never mutated
    after append, so holding the dict is safe)."""
    base: int                       # first global row (at snapshot time)
    rows: int
    path: Optional[str] = None      # segment file; None -> in-memory chunk
    chunk: Optional[Dict[str, np.ndarray]] = None
    zone_map: Optional[ZoneMap] = None   # None: not prunable (chunks, legacy)

    def read(self, cols: Optional[Tuple[str, ...]] = None
             ) -> Dict[str, np.ndarray]:
        """Columns of this unit; ``cols=None`` reads all.  Segment reads
        decompress only the requested members (predicate/column pushdown:
        a pruned column set is an actual IO reduction, not cosmetic)."""
        if self.chunk is not None:
            if cols is None:
                return dict(self.chunk)
            return {k: self.chunk[k] for k in cols if k in self.chunk}
        with np.load(self.path) as seg:
            names = seg.files if cols is None else \
                [k for k in cols if k in seg.files]
            return {k: seg[k] for k in names}


class PartitionSnapshot:
    """A consistent, pinned view of one partition: unit list + pk-index
    copy + row watermark captured under a single lock acquisition.  While
    pinned, compaction defers deleting replaced segment files, so every
    unit stays readable.  ``release()`` (or the context manager) unpins."""

    def __init__(self, part: "StoragePartition", units: List[SnapshotUnit],
                 pks: np.ndarray, rows: np.ndarray, watermark: int,
                 epoch: int):
        self._part = part
        self.units = units
        self._pks = pks
        self._rows = rows
        self.watermark = watermark          # rows_total at snapshot time
        self.epoch = epoch
        self._released = False

    @property
    def pid(self) -> int:
        return self._part.pid

    def live_mask(self, ids: np.ndarray, base: int) -> np.ndarray:
        """Latest-wins over superseded/deleted versions: a scanned row is
        live iff the snapshot's pk index still points at its position."""
        ids = np.asarray(ids, np.int64)
        found, loc, _ = nputil.sorted_find(self._pks, ids)
        cur = np.full(ids.shape[0], -1, np.int64)
        cur[found] = self._rows[loc[found]]
        return cur == np.arange(base, base + ids.shape[0])

    @property
    def live_rows(self) -> int:
        return int(self._pks.shape[0])

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._part._unpin()

    def __enter__(self) -> "PartitionSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class StoragePartition:
    # deferred-durability window for repair's lineage advances: the
    # manifest rewrite (JSON + rename, under the partition lock) happens
    # at most once per this many seconds outside of flushes — a crash in
    # the window only regresses lineage to an OLDER version, which the
    # repair scheduler treats as stale and safely re-probes
    LINEAGE_SYNC_S = 1.0

    def __init__(self, pid: int, spill_dir: Optional[str] = None,
                 segment_rows: int = 100_000,
                 zone_map_cols: Optional[Tuple[str, ...]] = None,
                 sort_key: Optional[str] = None, obs=None):
        self.pid = pid
        # observability (core/obs): flush telemetry is RECORDED under the
        # partition lock (plain list append) but PUBLISHED — histogram
        # observe + span emit — only after release, by the next public
        # write/flush on this partition (feedlint R6 discipline)
        self._obs = obs
        self._flush_hist = (obs.registry.histogram("store_flush_s")
                            if obs is not None else None)
        # (rows, dur, span ids) per queued flush; span ids are the trace
        # stamps of the batches buffered since the previous flush, so a
        # traced journey closes at store.flush (core/obs/profile.py)
        self._flush_events: List[Tuple[int, float, Tuple[int, ...]]] = \
            []                                          # guarded-by: _lock
        self._pending_sids: List[int] = []              # guarded-by: _lock
        self.spill_dir = spill_dir
        self.segment_rows = segment_rows
        # None = zone-map every eligible column; () disables
        self.zone_map_cols = zone_map_cols
        # sort each segment's rows by this column at flush (ingestion-time
        # clustering).  NOTE: with a sort key, scan() order within a
        # segment is no longer append order — latest-wins resolution must
        # go through the pk index (snapshot_view), which is remapped with
        # the permutation and stays exact.
        self.sort_key = sort_key
        self._chunks: List[Dict[str, np.ndarray]] = []      # guarded-by: _lock
        self._chunk_lineage: List[Optional[Lineage]] = []   # guarded-by: _lock
        self._rows_buffered = 0                             # guarded-by: _lock
        self._index = _PkIndex()     # guarded-by: _lock — pk -> global row
        self._rows_total = 0                                # guarded-by: _lock
        self._seg_seq = 0            # guarded-by: _lock — file-name counter
        self._seg_files: List[str] = []                     # guarded-by: _lock
        self._seg_rows: List[int] = []                      # guarded-by: _lock
        self._seg_lineage: List[Lineage] = []               # guarded-by: _lock
        self._seg_zmaps: List[ZoneMap] = []                 # guarded-by: _lock
        self._seg_dead: List[int] = []   # guarded-by: _lock — dead/segment
        self._seg_level: List[int] = []  # guarded-by: _lock — merge generation
        self._chunk_dead = 0             # guarded-by: _lock — dead, buffered
        self._epoch = 0              # guarded-by: _lock — layout epoch
        self._pins = 0               # guarded-by: _lock — live snapshot views
        self._garbage: List[str] = []    # guarded-by: _lock — awaiting unpin
        self._manifest_dirty = False                        # guarded-by: _lock
        self._manifest_last_s = float("-inf")   # guarded-by: _lock
        self._lock = threading.Lock()           # lock-name: partition
        if spill_dir:
            os.makedirs(os.path.join(spill_dir, f"p{pid}"), exist_ok=True)

    # ------------------------------------------------------------- internals
    def _seg_path(self, fname: str) -> str:
        return os.path.join(self.spill_dir, f"p{self.pid}", fname)

    def _flushed_rows_locked(self) -> int:  # requires-lock: _lock
        return int(sum(self._seg_rows))

    def _note_dead_locked(self, old_rows: np.ndarray) -> None:  # requires-lock: _lock
        """Exact garbage accounting: ``old_rows`` are global positions
        whose row version just became superseded or deleted."""
        if old_rows.size == 0:
            return
        flushed = self._flushed_rows_locked()
        seg_side = old_rows[old_rows < flushed]
        self._chunk_dead += int(old_rows.shape[0] - seg_side.shape[0])
        if seg_side.size:
            bounds = np.cumsum(self._seg_rows)
            seg_of = np.searchsorted(bounds, seg_side, side="right")
            for s, c in zip(*np.unique(seg_of, return_counts=True)):
                self._seg_dead[int(s)] += int(c)

    # ---------------------------------------------------------------- writes
    def insert(self, batch: Dict[str, np.ndarray], upsert: bool,
               lineage: Optional[Lineage] = None,
               span_ids: Tuple[int, ...] = ()) -> int:
        """Insert valid rows; returns #rows newly stored (duplicates skipped
        in insert mode, remapped in upsert mode).  ``lineage`` is the ref
        versions the batch was enriched under, recorded per chunk;
        ``span_ids`` are the batch's trace stamps — buffered until the
        next flush so its ``store.flush`` span names the journeys it
        closed."""
        valid = batch["valid"]
        ids = np.asarray(batch["id"][valid], np.int64)
        if ids.size == 0:
            return 0
        with self._lock:
            if span_ids and self._obs is not None:
                self._pending_sids.extend(span_ids)
                if len(self._pending_sids) > 4096:
                    # bounded like the sample rings: drop oldest stamps
                    del self._pending_sids[:len(self._pending_sids) // 2]
            fresh_mask = ~self._index.contains(ids)
            take = np.ones(len(ids), bool) if upsert else fresh_mask
            if not take.any():
                return 0
            rows = {k: v[valid][take] for k, v in batch.items()}
            n = int(take.sum())
            base = self._rows_total
            if upsert:
                # positions this batch supersedes: previous versions of the
                # re-written pks (each counted once, however many times the
                # batch repeats the pk), plus within-batch duplicates — the
                # index keeps the last occurrence, so earlier copies of the
                # same pk in this chunk are dead on arrival
                uniq = np.unique(ids[take])
                old = self._index.lookup(uniq)
                self._note_dead_locked(old[old >= 0])
                self._chunk_dead += n - int(uniq.shape[0])
            self._index.put(ids[take], np.arange(base, base + n))
            self._append_locked(rows, n, lineage)
            stored = int((fresh_mask & take).sum())
        self._drain_flush_events()
        return stored

    def _append_locked(self,  # requires-lock: _lock
                       rows: Dict[str, np.ndarray], n: int,
                       lineage: Optional[Lineage]) -> None:
        self._chunks.append(rows)
        self._chunk_lineage.append(dict(lineage) if lineage else None)
        self._rows_buffered += n
        self._rows_total += n
        if self.spill_dir and self._rows_buffered >= self.segment_rows:
            self._flush_locked()

    def _flush_locked(self) -> None:  # requires-lock: _lock
        # feedlint: allow[blocking-under-lock] flush is atomic by design:
        # segment write + manifest + index update in one lock window
        if not self._chunks:
            return
        t_flush = time.perf_counter()
        seg = {k: np.concatenate([c[k] for c in self._chunks])
               for k in self._chunks[0]}
        n = int(seg["id"].shape[0])
        lo = self._flushed_rows_locked()
        if self.sort_key is not None and self.sort_key in seg:
            order = np.argsort(seg[self.sort_key], kind="stable")
            if not np.array_equal(order, np.arange(n)):
                seg = {k: v[order] for k, v in seg.items()}
                inv = np.empty(n, np.int64)
                inv[order] = np.arange(n)
                # pure permutation: positions move within [lo, lo+n) only,
                # so no epoch bump — a stale conditional check can never
                # spuriously match (the checked pk's OWN position moved)
                self._index.remap_span(lo, lo + n, lo + inv)
        fname = f"seg{self._seg_seq:06d}.npz"
        self._seg_seq += 1
        path = self._seg_path(fname)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # file handle: savez won't append ".npz"
            np.savez_compressed(f, **seg)
            f.flush()
            os.fsync(f.fileno())    # durable BEFORE the manifest cites it
        os.replace(tmp, path)       # atomic commit
        self._seg_files.append(fname)
        self._seg_rows.append(n)
        self._seg_lineage.append(merge_lineage(self._chunk_lineage))
        self._seg_zmaps.append(compute_zone_map(seg, self.zone_map_cols))
        self._seg_level.append(0)   # fresh flushes enter at level 0
        # exact recount for the new segment; buffered garbage moved with it
        live = self._index.lookup(seg["id"]) == np.arange(lo, lo + n)
        self._seg_dead.append(int(n - live.sum()))
        self._chunk_dead = 0
        self._write_manifest_locked()
        self._chunks = []
        self._chunk_lineage = []
        self._rows_buffered = 0
        if self._obs is not None:
            self._flush_events.append((n, time.perf_counter() - t_flush,
                                       tuple(self._pending_sids)))
            self._pending_sids.clear()

    def _write_manifest_locked(self) -> None:  # requires-lock: _lock
        # feedlint: allow[blocking-under-lock] manifest rewrite must be
        # consistent with the in-memory segment tables it snapshots
        man = self._seg_path("MANIFEST.json")
        # format history: 1 = counts only (seg_files/lineage implicit),
        # 2 = + per-segment lineage and zone maps, 3 = + per-segment
        # merge levels.  recover() reads all three; see docs/STORAGE.md.
        manifest = {"format": 3,
                    "segments": len(self._seg_files),
                    "rows": int(sum(self._seg_rows)),
                    "seq": self._seg_seq,
                    "seg_files": self._seg_files,
                    "seg_rows": self._seg_rows,
                    "lineage": self._seg_lineage,
                    "zone_maps": [
                        {k: [v[0], v[1]] for k, v in zm.items()}
                        for zm in self._seg_zmaps],
                    "levels": self._seg_level}
        with open(man + ".tmp", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())  # a crash must never leave a torn/empty
        if os.path.exists(man):   # manifest; the previous one survives as
            os.replace(man, man + ".bak")  # .bak for recover()'s fallback
        os.replace(man + ".tmp", man)
        fsync_dir(os.path.dirname(man))
        self._manifest_dirty = False
        self._manifest_last_s = time.monotonic()

    def _lineage_sync_locked(self) -> None:  # requires-lock: _lock
        """Durability for a lineage-only manifest change, throttled: repair
        advances segment lineage far more often than segments flush, and a
        JSON rewrite under the partition lock would stall concurrent
        ingest inserts — so at most one rewrite per LINEAGE_SYNC_S, the
        rest deferred to the next flush/sync (a crash in the window just
        re-probes: lineage only ever regresses to OLDER = stale = safe)."""
        if time.monotonic() - self._manifest_last_s >= self.LINEAGE_SYNC_S:
            self._write_manifest_locked()
        else:
            self._manifest_dirty = True

    def flush(self) -> None:
        if self.spill_dir:
            with self._lock:
                self._flush_locked()
                if self._manifest_dirty:
                    self._write_manifest_locked()
            self._drain_flush_events()

    def _drain_flush_events(self) -> None:
        """Publish queued flush telemetry with NO lock held.  Flushes
        that happen inside other lock windows (compaction's hazard
        flush) stay queued until the next public write/flush — late,
        never lost, never emitted under a core lock."""
        if self._obs is None:
            return
        with self._lock:
            if not self._flush_events:
                return
            events, self._flush_events = self._flush_events, []
        for n, dur, sids in events:
            self._flush_hist.observe(dur)
            self._obs.emit("store.flush", sids, t0=time.monotonic() - dur,
                           dur=dur, rows=n, partition=self.pid)

    def _load_manifest_locked(self) -> Optional[Dict]:
        # requires-lock: _lock
        # feedlint: allow[blocking-under-lock] cold-start manifest read
        """Load MANIFEST.json, falling back to the ``.bak`` predecessor
        when the current file is torn/empty (a pre-fsync-era crash, or a
        filesystem that reordered the rename).  Falling back one
        manifest is sound: every writer commits the new manifest BEFORE
        unlinking any segment file it dropped (see compact_segment), so
        a .bak's segment list is still fully on disk.  No manifest at
        all = fresh partition; an unreadable manifest with no readable
        .bak raises — silently recovering empty would drop data."""
        man = self._seg_path("MANIFEST.json")
        if not (os.path.exists(man) or os.path.exists(man + ".bak")):
            return None
        err: Optional[Exception] = None
        for path in (man, man + ".bak"):
            try:
                with open(path) as f:
                    doc = json.load(f)
                if isinstance(doc, dict) and "segments" in doc:
                    return doc
                err = err or ValueError(f"malformed manifest {path}")
            except (OSError, json.JSONDecodeError) as e:
                err = err or e
        raise RuntimeError(
            f"partition {self.pid}: MANIFEST.json unreadable and no "
            f"usable .bak fallback ({err})")

    def reset_lineage(self) -> None:
        """Recovery degrade path (core/recovery.py): when a restarted
        process's rebuilt ref tables don't fingerprint-match the
        checkpoint, recovered lineage versions are meaningless — reset
        every unit to ``{}`` (always-stale to the repair scheduler) so
        the feed re-scans everything rather than ever treating a row as
        silently current."""
        with self._lock:
            self._seg_lineage = [{} for _ in self._seg_files]
            self._chunk_lineage = [None] * len(self._chunks)
            if self.spill_dir and self._seg_files:
                self._write_manifest_locked()

    def recover(self) -> "StoragePartition":
        """Crash recovery: reload the manifested (durable) segments —
        counts, pk index, per-segment lineage, and zone maps; unflushed
        buffered chunks are, by definition, lost.  Pre-lineage and
        pre-zone-map manifests recover with empty lineage (always-stale to
        the repair scheduler) and no zone maps (never pruned) — both the
        safe side.  Dead-row counters are recomputed exactly from the
        rebuilt index."""
        if not self.spill_dir:
            raise RuntimeError("recover() requires spill_dir")
        # feedlint: allow[blocking-under-lock] cold-start reload: manifest
        # + segment reads happen before any concurrent user exists
        with self._lock:
            self._chunks, self._chunk_lineage = [], []
            self._rows_buffered = 0
            self._chunk_dead = 0
            self._index = _PkIndex()
            self._rows_total = 0
            self._seg_files, self._seg_rows = [], []
            self._seg_lineage, self._seg_zmaps, self._seg_dead = [], [], []
            self._seg_level = []
            manifest = self._load_manifest_locked()
            if manifest is None:
                return self
            nseg = int(manifest["segments"])
            files = manifest.get("seg_files") or \
                [f"seg{s:06d}.npz" for s in range(nseg)]
            lineage = manifest.get("lineage") or []
            zmaps = manifest.get("zone_maps") or []
            # format < 3 has no "levels": every segment recovers as
            # level 0, i.e. merge-eligible — the merge path then rebuilds
            # zone maps unconditionally, so legacy segments regain
            # pruning as they age
            levels = manifest.get("levels") or []
            seg_ids: List[np.ndarray] = []
            row = 0
            for s in range(nseg):
                with np.load(self._seg_path(files[s])) as seg:
                    ids = np.asarray(seg["id"], np.int64)
                n = int(ids.shape[0])
                self._index.put(ids, np.arange(row, row + n))
                seg_ids.append(ids)
                self._seg_files.append(files[s])
                self._seg_rows.append(n)
                self._seg_lineage.append(
                    dict(lineage[s]) if s < len(lineage) else {})
                self._seg_zmaps.append(
                    {k: (v[0], v[1]) for k, v in zmaps[s].items()}
                    if s < len(zmaps) else {})
                self._seg_level.append(
                    int(levels[s]) if s < len(levels) else 0)
                row += n
            self._seg_seq = int(manifest.get("seq", nseg))
            self._rows_total = row
            lo = 0
            for ids in seg_ids:
                n = ids.shape[0]
                live = self._index.lookup(ids) == np.arange(lo, lo + n)
                self._seg_dead.append(int(n - live.sum()))
                lo += n
        return self

    # ------------------------------------------------------------- snapshots
    def snapshot_view(self) -> PartitionSnapshot:
        """Pin and return a consistent view for the query subsystem: unit
        list, pk-index copy, and watermark under ONE lock acquisition.
        Chunks' arrays are immutable after append; segment files replaced
        by compaction stay on disk until the last pin releases."""
        with self._lock:
            self._pins += 1
            units: List[SnapshotUnit] = []
            base = 0
            for f, n, zm in zip(self._seg_files, self._seg_rows,
                                self._seg_zmaps):
                units.append(SnapshotUnit(base, n, path=self._seg_path(f),
                                          zone_map=zm or None))
                base += n
            for c in self._chunks:
                n = int(c["id"].shape[0])
                units.append(SnapshotUnit(base, n, chunk=c))
                base += n
            pks, rows = self._index.snapshot_arrays()
            return PartitionSnapshot(self, units, pks, rows,
                                     self._rows_total, self._epoch)

    def _unpin(self) -> None:
        with self._lock:
            self._pins -= 1
            if self._pins == 0:
                self._gc_locked()

    def _gc_locked(self) -> None:  # requires-lock: _lock
        # feedlint: allow[blocking-under-lock] unlink of replaced files;
        # must not race a concurrent compaction's swap
        for f in self._garbage:
            try:
                os.unlink(f)
            except OSError:
                pass
        self._garbage = []

    # ------------------------------------------------------------ compaction
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def dead_rows(self) -> int:
        """Superseded/deleted row versions still occupying storage."""
        with self._lock:
            return int(sum(self._seg_dead)) + self._chunk_dead

    def garbage_units(self) -> List[Tuple[Optional[int], int, int]]:
        """Compaction candidates: ``(segment_index | None, rows, dead)``
        — one entry per flushed segment plus one (``None``) for the
        buffered chunks."""
        with self._lock:
            out: List[Tuple[Optional[int], int, int]] = [
                (s, n, d) for s, (n, d)
                in enumerate(zip(self._seg_rows, self._seg_dead))]
            out.append((None, self._rows_buffered, self._chunk_dead))
            return out

    def segment_stats(self) -> List[Tuple[int, int, int]]:
        """Merge-policy input: ``(rows, dead, level)`` per flushed
        segment, in segment order (the list index IS the segment index a
        subsequent ``merge_segments`` call takes — callers must tolerate
        rejection if the layout moved in between)."""
        with self._lock:
            return list(zip(self._seg_rows, self._seg_dead,
                            self._seg_level))

    def level_histogram(self) -> Dict[int, int]:
        """``{level: segment count}`` over the flushed segments."""
        with self._lock:
            hist: Dict[int, int] = {}
            for lv in self._seg_level:
                hist[lv] = hist.get(lv, 0) + 1
            return hist

    def compact_segment(self, si: int) -> int:
        """Rewrite flushed segment ``si`` without its superseded/deleted
        row versions and rebuild its zone maps; returns rows dropped.
        Runs entirely under the partition lock (decide + rewrite + swap in
        one atomic window — a budgeted background caller amortizes the
        stall; see core/compaction.py).  Renumbers the position space when
        rows drop, so the layout epoch bumps and in-flight conditional
        repairs against the old numbering are rejected, not misapplied.
        The replaced file is deleted once no snapshot pins remain.  A
        segment with no dead rows only refreshes missing zone maps."""
        # feedlint: allow[blocking-under-lock] deliberate: decide + rewrite
        # + swap in ONE lock window so the renumbering is atomic; the
        # caller (compaction.py) budgets the stall
        with self._lock:
            if not (0 <= si < len(self._seg_files)):
                raise IndexError(f"segment {si} out of range")
            path = self._seg_path(self._seg_files[si])
            with np.load(path) as f:
                seg = {k: f[k] for k in f.files}
            n = int(seg["id"].shape[0])
            lo = int(sum(self._seg_rows[:si]))
            pos = self._index.lookup(seg["id"])
            live = pos == np.arange(lo, lo + n)
            # a superseded version whose NEWER version still sits in a
            # buffered chunk (repair_rows re-appends at the tail) is the
            # row's only durable copy: flush inside this lock window
            # before physically dropping it, or a crash before the next
            # flush loses the row outright — its WAL frame was already
            # truncated by the checkpoint that made THIS version durable
            if bool((~live & (pos >= self._flushed_rows_locked())).any()):
                self._flush_locked()
            m = int(live.sum())
            if m == n:
                self._seg_dead[si] = 0
                if not self._seg_zmaps[si]:
                    self._seg_zmaps[si] = compute_zone_map(
                        seg, self.zone_map_cols)
                    self._write_manifest_locked()
                return 0
            if m == 0:
                # zero survivors: remove the segment entry outright (same
                # as a zero-survivor merge run).  Writing a 0-row segment
                # instead would wedge repair: lineage_units() would report
                # a permanently-stale empty unit that read_rows() cannot
                # return, so the unit never converges
                self._index.shift_from(lo + n, -n)
                del self._seg_files[si]
                del self._seg_rows[si]
                del self._seg_lineage[si]
                del self._seg_zmaps[si]
                del self._seg_dead[si]
                del self._seg_level[si]
                self._rows_total -= n
                self._epoch += 1
                self._write_manifest_locked()
                self._garbage.append(path)
                if self._pins == 0:
                    self._gc_locked()
                return n
            kept = {k: v[live] for k, v in seg.items()}
            fname = f"seg{self._seg_seq:06d}.npz"
            self._seg_seq += 1
            new_path = self._seg_path(fname)
            tmp = new_path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **kept)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, new_path)
            # renumber: kept rows compact to [lo, lo+m); the suffix of the
            # position space shifts down.  Every index entry in the span
            # points at a live row by construction.
            new_abs = np.full(n, -1, np.int64)
            new_abs[live] = lo + np.arange(m)
            self._index.remap_span(lo, lo + n, new_abs)
            self._index.shift_from(lo + n, -(n - m))
            self._seg_files[si] = fname
            self._seg_rows[si] = m
            self._seg_zmaps[si] = compute_zone_map(kept, self.zone_map_cols)
            self._seg_dead[si] = 0
            self._rows_total -= n - m
            self._epoch += 1
            # manifest BEFORE dropping the old file: a crash in between
            # must never leave the manifest pointing at a deleted segment
            self._write_manifest_locked()
            self._garbage.append(path)
            if self._pins == 0:
                self._gc_locked()
            return n - m

    def merge_segments(self, si: int, count: int) -> Tuple[int, int]:
        """Merge ``count`` adjacent flushed segments [si, si+count) into
        ONE segment at level ``max(input levels) + 1``: drop dead row
        versions, re-sort the union on ``sort_key`` (clustered layout
        deepens as data ages — the INGESTBASE argument for ingestion-time
        layout), rebuild zone maps **unconditionally** (legacy format-2
        segments regain pruning here), and min-merge lineage (oldest
        wins, conservative for staleness).  Returns ``(rows_merged,
        rows_dropped)``.

        Concurrency contract mirrors ``compact_segment``: decide +
        rewrite + swap in one lock window; the layout epoch ALWAYS bumps
        (cross-segment re-sort renumbers positions even with zero dead
        rows), so in-flight conditional repairs are rejected wholesale
        and simply re-scan; the replaced files outlive any snapshot pin
        and the manifest commits before they are queued for GC."""
        # feedlint: allow[blocking-under-lock] deliberate, same shape as
        # compact_segment: the merge must be atomic w.r.t. renumbering;
        # the caller (compaction.py) budgets the stall
        with self._lock:
            if count < 2 or si < 0 or si + count > len(self._seg_files):
                raise IndexError(
                    f"merge [{si}, {si + count}) out of range "
                    f"({len(self._seg_files)} segments)")
            paths = [self._seg_path(f)
                     for f in self._seg_files[si:si + count]]
            parts: List[Dict[str, np.ndarray]] = []
            for p in paths:
                with np.load(p) as f:
                    parts.append({k: f[k] for k in f.files})
            keys = set(parts[0])
            for part in parts[1:]:
                keys &= set(part)
            merged = {k: np.concatenate([p[k] for p in parts])
                      for k in keys}
            n = int(merged["id"].shape[0])
            lo = int(sum(self._seg_rows[:si]))
            pos = self._index.lookup(merged["id"])
            live = pos == np.arange(lo, lo + n)
            # same hazard as compact_segment: never drop a superseded
            # durable version while its successor is still buffered —
            # flush first (position-preserving, so ``lo``/``live`` and
            # the [si, si+count) window stay valid; the new segments
            # land after it and are untouched by the splice below)
            if bool((~live & (pos >= self._flushed_rows_locked())).any()):
                self._flush_locked()
            m = int(live.sum())
            dropped = n - m
            level = max(self._seg_level[si:si + count]) + 1
            lin = merge_lineage(
                [dict(x) for x in self._seg_lineage[si:si + count]])
            if m == 0:
                # nothing lives: the merged segment would be empty — drop
                # the inputs outright instead of writing a 0-row file
                self._index.shift_from(lo + n, -n)
                del self._seg_files[si:si + count]
                del self._seg_rows[si:si + count]
                del self._seg_lineage[si:si + count]
                del self._seg_zmaps[si:si + count]
                del self._seg_dead[si:si + count]
                del self._seg_level[si:si + count]
            else:
                kept = {k: v[live] for k, v in merged.items()}
                # destination offset of each surviving input row: compact
                # to [0, m), then permute by the sort order
                dest = np.arange(m)
                if self.sort_key is not None and self.sort_key in kept:
                    order = np.argsort(kept[self.sort_key], kind="stable")
                    if not np.array_equal(order, np.arange(m)):
                        kept = {k: v[order] for k, v in kept.items()}
                        inv = np.empty(m, np.int64)
                        inv[order] = np.arange(m)
                        dest = inv
                fname = f"seg{self._seg_seq:06d}.npz"
                self._seg_seq += 1
                new_path = self._seg_path(fname)
                tmp = new_path + ".tmp"
                with open(tmp, "wb") as f:
                    np.savez_compressed(f, **kept)
                    f.flush()
                    os.fsync(f.fileno())    # durable BEFORE the manifest
                os.replace(tmp, new_path)
                new_abs = np.full(n, -1, np.int64)
                new_abs[live] = lo + dest
                self._index.remap_span(lo, lo + n, new_abs)
                self._index.shift_from(lo + n, -dropped)
                self._seg_files[si:si + count] = [fname]
                self._seg_rows[si:si + count] = [m]
                self._seg_lineage[si:si + count] = [lin]
                self._seg_zmaps[si:si + count] = [
                    compute_zone_map(kept, self.zone_map_cols)]
                self._seg_dead[si:si + count] = [0]
                self._seg_level[si:si + count] = [level]
            self._rows_total -= dropped
            self._epoch += 1
            # manifest BEFORE dropping the old files: a crash in between
            # must never leave the manifest citing a deleted segment
            self._write_manifest_locked()
            self._garbage.extend(paths)
            if self._pins == 0:
                self._gc_locked()
            return n, dropped

    def compact_chunks(self) -> int:
        """Drop superseded/deleted row versions from the buffered
        (unflushed) chunks — the whole story for spill-less in-memory
        partitions; returns rows dropped.  Merges the survivors into one
        chunk carrying the min-merged lineage (conservative, like flush)."""
        with self._lock:
            if self._chunk_dead == 0 or not self._chunks:
                return 0
            merged = {k: np.concatenate([c[k] for c in self._chunks])
                      for k in self._chunks[0]}
            n = int(merged["id"].shape[0])
            lo = self._flushed_rows_locked()
            live = self._index.lookup(merged["id"]) == \
                np.arange(lo, lo + n)
            m = int(live.sum())
            if m == n:
                self._chunk_dead = 0
                return 0
            kept = {k: v[live] for k, v in merged.items()}
            lin = merge_lineage(self._chunk_lineage)
            new_abs = np.full(n, -1, np.int64)
            new_abs[live] = lo + np.arange(m)
            self._index.remap_span(lo, lo + n, new_abs)
            self._chunks = [kept] if m else []
            self._chunk_lineage = [lin or None] if m else []
            self._rows_buffered = m
            self._rows_total -= n - m
            self._chunk_dead = 0
            self._epoch += 1
            return n - m

    def compact(self, min_dead_frac: float = 0.0) -> int:
        """Compact every unit whose dead fraction reaches
        ``min_dead_frac`` (0.0 = reclaim everything); returns rows
        dropped.  Synchronous; the background job budgets the same
        primitives instead."""
        dropped = 0
        # reversed: an all-dead segment is deleted outright, shifting
        # later indices — walking high-to-low keeps pending ones valid
        for si, rows, dead in reversed(self.garbage_units()):
            if rows == 0 or dead == 0 or dead / rows < min_dead_frac:
                continue
            dropped += (self.compact_chunks() if si is None
                        else self.compact_segment(si))
        return dropped

    # -------------------------------------------------------------- lineage
    def lineage_units(self) -> List[Tuple[int, int, Lineage]]:
        """Snapshot of storage units for the repair scheduler: a list of
        ``(start_row, rows, lineage)`` covering flushed segments then
        buffered chunks, in global row order.  Unversioned chunks surface
        as ``{}`` (always stale when consulted)."""
        with self._lock:
            units: List[Tuple[int, int, Lineage]] = []
            cum = 0
            for r, lin in zip(self._seg_rows, self._seg_lineage):
                # skip 0-row segments (possible in legacy manifests):
                # an empty unit can never be read back, so surfacing it
                # would hand the repair scheduler unconvergeable work
                if r:
                    units.append((cum, r, dict(lin)))
                cum += r
            for c, lin in zip(self._chunks, self._chunk_lineage):
                r = int(c["id"].shape[0])
                units.append((cum, r, dict(lin) if lin else {}))
                cum += r
            return units

    def update_lineage(self, start_row: int, rows: int,
                       lineage: Lineage,
                       expect_epoch: Optional[int] = None) -> bool:
        """Advance one unit's lineage (per-table max) after the repair
        scheduler proved its rows current — e.g. a dirty-key probe matched
        nothing.  No-op (returns False) when the unit boundary no longer
        exists (it was flushed and merged into a segment mid-scan) or the
        layout epoch moved (compaction renumbered: the 'same' boundary may
        now cover different rows): the unit keeps its old lineage, stays
        stale, and is simply re-scanned — the conditional repair path
        makes that idempotent."""
        with self._lock:
            if expect_epoch is not None and expect_epoch != self._epoch:
                return False
            cum = 0
            for i, r in enumerate(self._seg_rows):
                if cum == start_row and r == rows:
                    self._seg_lineage[i] = {
                        t: max(self._seg_lineage[i].get(t, -1), v)
                        for t, v in lineage.items()}
                    self._lineage_sync_locked()
                    return True
                cum += r
            for i, c in enumerate(self._chunks):
                r = int(c["id"].shape[0])
                if cum == start_row and r == rows:
                    old = self._chunk_lineage[i] or {}
                    self._chunk_lineage[i] = {
                        t: max(old.get(t, -1), v)
                        for t, v in lineage.items()}
                    return True
                cum += r
            return False

    def read_rows(self, start: int, n: int) -> Dict[str, np.ndarray]:
        """Columns for global rows [start, start+n) — from disk segments
        and/or buffered chunks.  The span list AND the segment file names
        are captured under the lock, and the partition stays pinned for
        the duration, so the read is consistent even while a concurrent
        compaction replaces files (their content outlives the pin)."""
        with self._lock:
            self._pins += 1
            spans = [(self._seg_path(f), r) for f, r
                     in zip(self._seg_files, self._seg_rows)]
            chunks = list(self._chunks)
        try:
            parts: List[Dict[str, np.ndarray]] = []
            end = start + n
            cum = 0
            for path, r in spans:
                lo, hi = cum, cum + r
                cum += r
                if hi <= start or lo >= end:
                    continue
                with np.load(path) as seg:
                    a, b = max(start - lo, 0), min(end, hi) - lo
                    parts.append({k: seg[k][a:b] for k in seg.files})
            for c in chunks:
                r = int(c["id"].shape[0])
                lo, hi = cum, cum + r
                cum += r
                if hi <= start or lo >= end:
                    continue
                a, b = max(start - lo, 0), min(end, hi) - lo
                parts.append({k: v[a:b] for k, v in c.items()})
            if not parts:
                raise IndexError(f"rows [{start}, {end}) out of range")
            if len(parts) == 1:
                return parts[0]
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        finally:
            self._unpin()

    def repair_rows(self, batch: Dict[str, np.ndarray],
                    global_rows: np.ndarray,
                    lineage: Optional[Lineage],
                    expect_epoch: Optional[int] = None) -> int:
        """In-place upsert of re-enriched rows, exactly-once under
        concurrent ingestion: a row is applied only if the pk index still
        points at the global row it was scanned from — a concurrent ingest
        upsert (which remapped the pk) always wins, and a repeated scan of
        the same unit is a no-op.  ``expect_epoch`` extends the guarantee
        across compaction: after a renumbering, freed position numbers can
        be reused, so the positional check alone could spuriously match —
        an epoch mismatch rejects the whole batch (the unit stays stale
        and is re-scanned).  Returns #rows actually repaired."""
        ids = np.asarray(batch["id"], np.int64)
        if ids.size == 0:
            return 0
        with self._lock:
            if expect_epoch is not None and expect_epoch != self._epoch:
                return 0
            live = self._index.lookup(ids) == np.asarray(global_rows,
                                                         np.int64)
            if not live.any():
                return 0
            rows = {k: v[live] for k, v in batch.items()}
            n = int(live.sum())
            base = self._rows_total
            self._note_dead_locked(
                np.asarray(global_rows, np.int64)[live])
            self._index.put(ids[live], np.arange(base, base + n))
            self._append_locked(rows, n, lineage)
        self._drain_flush_events()
        return n

    def delete_rows(self, ids: np.ndarray, global_rows: np.ndarray,
                    expect_epoch: Optional[int] = None) -> int:
        """Conditionally delete rows (repair filter-deletes): a pk is
        removed from the index only if it still points at the global row
        it was scanned from, so a concurrent ingest upsert always wins and
        re-scans are no-ops — the same exactly-once contract as
        ``repair_rows``, epoch check included.  The row versions become
        dead storage, reclaimed by compaction.  Returns #rows deleted."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return 0
        with self._lock:
            if expect_epoch is not None and expect_epoch != self._epoch:
                return 0
            live = self._index.lookup(ids) == np.asarray(global_rows,
                                                         np.int64)
            if not live.any():
                return 0
            self._note_dead_locked(
                np.asarray(global_rows, np.int64)[live])
            return self._index.remove(ids[live])

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._index)

    @property
    def rows_total(self) -> int:
        """All stored row versions, including logically superseded ones
        (shrinks when compaction reclaims them)."""
        with self._lock:
            return self._rows_total

    def scan(self):
        """Yield column chunks (flushed segments read back from disk, then
        buffered chunks).  Superseded row versions still appear; without a
        ``sort_key`` they resolve by 'latest occurrence wins' in scan
        order, but the exact contract — deletes included — is the pk
        index, i.e. ``snapshot_view()``/the query subsystem."""
        with self._lock:
            self._pins += 1
            paths = [self._seg_path(f) for f in self._seg_files]
            chunks = list(self._chunks)
        try:
            for path in paths:
                with np.load(path) as seg:
                    yield {k: seg[k] for k in seg.files}
            yield from chunks
        finally:
            self._unpin()

    def get(self, pk: int) -> Optional[Dict[str, Any]]:
        seg_path = None
        with self._lock:
            row = self._index.get(int(pk))
            if row is None:
                return None
            # locate the row across flushed segments + buffered chunks
            offset = self._rows_total - sum(
                c["id"].shape[0] for c in self._chunks)
            if row >= offset:
                r = row - offset
                for c in self._chunks:
                    if r < c["id"].shape[0]:
                        return {k: v[r] for k, v in c.items()}
                    r -= c["id"].shape[0]
            if not self.spill_dir:
                return None
            r = row
            for fname, n in zip(self._seg_files, self._seg_rows):
                if r < n:
                    seg_path = self._seg_path(fname)
                    break
                r -= n
            if seg_path is None:
                return None
            # pin like scan()/read_rows(): the segment decompress happens
            # OUTSIDE the partition lock, and the pin keeps the file on
            # disk if compaction replaces it mid-read (feedlint R3 found
            # the old version holding the lock across np.load).
            self._pins += 1
        try:
            with np.load(seg_path) as seg:
                return {k: seg[k][r] for k in seg.files}
        finally:
            self._unpin()


class StorageJob:
    """Hash partitioner + P column-store partitions (paper Fig 23's Storage
    Partition Holder feeds this through an active holder — see feed.py)."""

    def __init__(self, num_partitions: int, spill_dir: Optional[str] = None,
                 upsert: bool = False, segment_rows: int = 100_000,
                 zone_map_cols: Optional[Tuple[str, ...]] = None,
                 sort_key: Optional[str] = None, obs=None, device=None):
        self.partitions = [StoragePartition(i, spill_dir, segment_rows,
                                            zone_map_cols, sort_key, obs=obs)
                           for i in range(num_partitions)]
        self.upsert = upsert
        # where queries aggregate (core/query.py); None means the card
        self.device = device
        # counters are write-guarded: mutated under the stats lock by
        # concurrent holder workers, read lock-free after join/drain
        self.stored = 0          # write-guarded-by: _lock
        self.batches = 0         # write-guarded-by: _lock — write() calls
        self.write_s = 0.0       # write-guarded-by: _lock
        # per-unit read tallies from the query layer ((pid, unit tag) ->
        # count; the PIQUE roadmap item's access-frequency signal)
        self._seg_reads: Dict[Tuple[int, str], int] = {}  # guarded-by: _lock
        self._lock = threading.Lock()    # lock-name: store-stats

    def write(self, batch: Dict[str, np.ndarray],
              lineage: Optional[Lineage] = None,
              span_ids: Tuple[int, ...] = ()) -> int:
        """Hash-partition one enriched batch by primary key and insert.
        The batch may be shared with other sinks of the same plan (tee
        fan-out): treated as read-only — rows are masked into fresh arrays,
        never mutated in place.  ``lineage`` is the ref-version tuple the
        batch was enriched under (recorded per stored chunk); ``span_ids``
        are the batch's trace stamps, threaded to each touched partition
        so its next ``store.flush`` span carries them."""
        t0 = time.perf_counter()
        npart = len(self.partitions)
        part = (batch["id"] % npart).astype(np.int64)
        stored = 0
        for p in range(npart):
            m = (part == p) & batch["valid"]
            if not m.any():
                continue
            sub = {k: v[m] for k, v in batch.items()}
            sub["valid"] = np.ones(int(m.sum()), bool)
            stored += self.partitions[p].insert(sub, self.upsert, lineage,
                                                span_ids=span_ids)
        with self._lock:
            self.stored += stored
            self.batches += 1
            self.write_s += time.perf_counter() - t0
        return stored

    @property
    def count(self) -> int:
        return sum(p.count for p in self.partitions)

    @property
    def dead_rows(self) -> int:
        return sum(p.dead_rows for p in self.partitions)

    @property
    def rows_total(self) -> int:
        return sum(p.rows_total for p in self.partitions)

    @property
    def segment_count(self) -> int:
        """Flushed segments across all partitions (the per-unit scan
        overhead the merge policy exists to shrink)."""
        return sum(len(p.segment_stats()) for p in self.partitions)

    def level_histogram(self) -> Dict[int, int]:
        """``{level: segment count}`` across all partitions — level 0 is
        fresh flushes, level k+1 holds merges of level-<=k segments."""
        hist: Dict[int, int] = {}
        for p in self.partitions:
            for lv, c in p.level_histogram().items():
                hist[lv] = hist.get(lv, 0) + c
        return hist

    def note_unit_reads(self, items) -> None:
        """Record per-unit read counts from a query execution.  The query
        layer tallies locally per ``execute()`` and publishes here ONCE,
        outside every scan lock, so the hot per-unit loop never touches
        this lock."""
        with self._lock:
            for key, n in items:
                self._seg_reads[key] = self._seg_reads.get(key, 0) + n

    def segment_read_counts(self) -> Dict[Tuple[int, str], int]:
        """``(partition, unit tag) -> reads`` since startup — how often
        each segment/chunk was scanned by the query subsystem (the
        access-frequency input a PIQUE-style adaptive layout needs)."""
        with self._lock:
            return dict(self._seg_reads)

    def scan(self):
        for p in self.partitions:
            yield from p.scan()

    def get(self, pk: int) -> Optional[Dict[str, Any]]:
        return self.partitions[int(pk) % len(self.partitions)].get(pk)

    def flush(self) -> None:
        for p in self.partitions:
            p.flush()

    def compact(self, min_dead_frac: float = 0.0) -> int:
        """Synchronously reclaim superseded/deleted row versions across
        every partition; returns rows dropped (the background job in
        core/compaction.py budgets the same primitives instead)."""
        return sum(p.compact(min_dead_frac) for p in self.partitions)

    def query(self) -> "Query":  # noqa: F821 (forward ref, lazy import)
        """Entry point of the analytical query subsystem: a composable
        ``Query`` builder over a snapshot-consistent view of this store
        (see core/query.py)."""
        from repro_torch.core.query import Query
        return Query(self)

    def snapshot(self) -> "StoreSnapshot":  # noqa: F821
        from repro_torch.core.query import StoreSnapshot
        return StoreSnapshot(self)

    def recover(self) -> "StorageJob":
        for p in self.partitions:
            p.recover()
        return self

    def reset_lineage(self) -> None:
        """All units in every partition -> always-stale (see
        StoragePartition.reset_lineage)."""
        for p in self.partitions:
            p.reset_lineage()
