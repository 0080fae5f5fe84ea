"""Background segment compaction: reclaim superseded and deleted row
versions so analytical scans don't degrade as upserts and repair churn
rows (otherwise superseded row versions accumulate append-only).

Declared on the plan's store sink next to the repair policy:

    .store(refresh=RepairSpec(...),
           compact=CompactionSpec(budget_rows_s=..., min_dead_frac=...))

The job shares the repair scheduler's citizenship model — it is a
*background* maintenance task:

  * **token bucket** on scanned rows/s (a compaction rewrites every row of
    the segment it touches, so segment rows are the honest cost unit) with
    a deliberately shallow burst;
  * **yields to ingestion**: while the feed has computing backlog, or an
    elastic group is scaled above its floor, the job skips its cycle
    (``repair.feed_busy`` — the same test the repair scheduler uses);
  * **trigger** per unit: dead fraction (exactly tracked by the storage
    layer's per-segment counters — no scan needed to decide) at or above
    ``min_dead_frac``.

Beyond dead-row reclaim the job also owns the **leveled merge policy**
(``level_target_rows``/``merge_fanin``): contiguous runs of small
segments are merged into one next-level segment, re-sorted on the
store's ``sort_key`` and with zone maps rebuilt, so per-unit scan
overhead shrinks as data ages (see docs/STORAGE.md).

Correctness is owned by the storage layer's primitives
(``compact_segment``/``compact_chunks``/``merge_segments``): the
decide+rewrite+swap runs atomically under the partition lock, the layout
epoch bump fences in-flight conditional repairs, and pinned query
snapshots keep replaced segment files readable until released.  This
module only *schedules*.  ``drain()`` compacts everything regardless of
budget (benchmarks and tests use it to assert 100% reclaim);
``merge_now()`` is the synchronous analogue for merging."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

from repro_torch.core.repair import feed_busy
from repro_torch.core.storage import StorageJob


@dataclasses.dataclass(frozen=True)
class CompactionSpec:
    """Compaction policy for one plan's store sink (``.store(compact=...)``).

    ``budget_rows_s`` caps rewritten rows/s (the knob trading space reclaim
    against ingestion interference); ``min_dead_frac`` is the per-unit
    trigger — rewriting a segment that is 2% garbage wastes IO, one that is
    half garbage halves the scan cost of every future query over it.

    ``level_target_rows`` > 0 additionally enables **leveled merging**
    (size-tiered): a contiguous run of at least ``merge_fanin`` flushed
    segments, each smaller than the target, is merged into ONE segment at
    the next level — re-sorted on the store's ``sort_key``, zone maps
    rebuilt — so per-unit scan overhead shrinks as data ages instead of
    staying flat at flush-size segments.  A segment at or above the
    target **graduates**: it is never merged again, which bounds write
    amplification to O(log_fanin(target/flush)) copies per row."""
    budget_rows_s: float = 50_000.0
    min_dead_frac: float = 0.25
    interval_s: float = 0.25       # scheduler cadence
    yield_backlog_batches: float = 0.0   # same semantics as RepairSpec's
    burst_s: float = 0.1
    merge_fanin: int = 8           # max (and trigger) segments per merge
    level_target_rows: int = 0     # 0 disables merging

    def __post_init__(self):
        if self.budget_rows_s <= 0:
            raise ValueError("budget_rows_s must be > 0")
        if not 0.0 <= self.min_dead_frac <= 1.0:
            raise ValueError("min_dead_frac must be in [0, 1]")
        if self.interval_s <= 0 or self.burst_s <= 0:
            raise ValueError("interval_s and burst_s must be > 0")
        if self.yield_backlog_batches < 0:
            raise ValueError("yield_backlog_batches must be >= 0")
        if self.merge_fanin < 2:
            raise ValueError("merge_fanin must be >= 2")
        if self.level_target_rows < 0:
            raise ValueError("level_target_rows must be >= 0")


@dataclasses.dataclass
class CompactionStats:
    segments_compacted: int = 0
    chunk_compactions: int = 0
    rows_dropped: int = 0        # superseded/deleted versions reclaimed
    rows_rewritten: int = 0      # live rows copied into new segments
    steps: int = 0
    yields: int = 0
    compact_s: float = 0.0
    merges: int = 0              # merge operations (K segments -> 1)
    segments_merged: int = 0     # input segments consumed by merges
    rows_merged: int = 0         # rows read (live + dead) by merges


def find_merge_run(stats, fanin: int, target_rows: int,
                   min_run: Optional[int] = None
                   ) -> Optional[Tuple[int, int, int]]:
    """First mergeable run in one partition's ``segment_stats()`` output:
    ``(start_index, count, total_rows)`` over a contiguous run of
    below-target segments at least ``min_run`` (default: ``fanin``) long,
    capped at ``fanin`` inputs per merge — or None.  Pure policy; the
    caller re-validates against the live layout via ``merge_segments``'s
    own bounds check."""
    if target_rows <= 0:
        return None
    need = fanin if min_run is None else min_run
    i, nseg = 0, len(stats)
    while i < nseg:
        if stats[i][0] >= target_rows:
            i += 1
            continue
        j = i                     # extend the run, up to fanin inputs
        while j < nseg and stats[j][0] < target_rows and j - i < fanin:
            j += 1
        if j - i >= max(need, 2):
            return (i, j - i,
                    int(sum(rows for rows, _d, _l in stats[i:j])))
        while j < nseg and stats[j][0] < target_rows:
            j += 1                # run too short: skip past all of it
        i = j
    return None


class CompactionJob(threading.Thread):
    """Budgeted background compactor for one feed's store (one thread;
    ``step()`` is synchronous and internally serialized so tests and
    ``drain()`` call it directly)."""

    def __init__(self, storage: StorageJob, spec: CompactionSpec,
                 batch_size: int = 420, handle=None, name: str = "store"):
        super().__init__(name=f"{name}-compact", daemon=True)
        self.storage = storage
        self.spec = spec
        self.batch_size = batch_size
        self.handle = handle      # duck-typed FeedHandle (None in tests)
        self._obs = getattr(handle, "obs", None)
        self.stats = CompactionStats()
        self.error: Optional[BaseException] = None
        # serializes step(); dedicated background lock — the segment
        # rewrites it triggers block under the partition lock by design
        self._step_lock = threading.Lock()  # lock-name: compaction-step blocking-ok
        self._stop_evt = threading.Event()
        self._tokens = spec.budget_rows_s * spec.burst_s  # guarded-by: _step_lock
        self._last_refill = time.monotonic()              # guarded-by: _step_lock

    # ----------------------------------------------------------- scheduling
    def run(self) -> None:
        while not self._stop_evt.wait(self.spec.interval_s):
            try:
                self.step()
            except BaseException as e:   # surfaced by FeedHandle.join()
                self.error = e
                return

    def stop(self) -> None:
        self._stop_evt.set()

    def _refill(self, now: float) -> None:  # requires-lock: _step_lock
        cap = self.spec.budget_rows_s * self.spec.burst_s
        self._tokens = min(cap, self._tokens + (now - self._last_refill)
                           * self.spec.budget_rows_s)
        self._last_refill = now

    def step(self, force: bool = False) -> int:
        """One pass over the store's garbage units; returns rows dropped.
        ``force`` ignores the budget, the backlog yield, and the dead-
        fraction trigger (the drain path)."""
        with self._step_lock:
            t0 = time.perf_counter()
            self.stats.steps += 1
            self._refill(time.monotonic())
            if not force:
                if feed_busy(self.handle,
                             self.spec.yield_backlog_batches
                             * self.batch_size):
                    self.stats.yields += 1
                    return 0
                if self._tokens <= 0:
                    return 0
            frac = 0.0 if force else self.spec.min_dead_frac
            dropped = 0
            for part in self.storage.partitions:
                # reversed: an all-dead segment is deleted outright,
                # shifting later indices — walking high-to-low keeps
                # the rest of this stale snapshot valid
                for si, rows, dead in reversed(part.garbage_units()):
                    if rows == 0 or dead == 0 or \
                            (rows and dead / rows < frac):
                        continue
                    if not force and self._tokens <= 0:
                        break
                    self._tokens -= rows     # rewritten rows cost budget
                    if si is None:
                        got = part.compact_chunks()
                        self.stats.chunk_compactions += int(got > 0)
                    else:
                        got = part.compact_segment(si)
                        self.stats.segments_compacted += int(got > 0)
                    self.stats.rows_dropped += got
                    self.stats.rows_rewritten += rows - got
                    dropped += got
            if self.spec.level_target_rows > 0:
                dropped += self._merge_pass(force)
            self.stats.compact_s += time.perf_counter() - t0
            return dropped

    def _merge_pass(self, force: bool,  # requires-lock: _step_lock
                    min_run: Optional[int] = None) -> int:
        """Leveled-merge scheduling pass over every partition; returns
        rows dropped (dead versions that vanish inside merges).  Policy
        is ``find_merge_run``; correctness (epoch fence, pinned-snapshot
        GC, manifest ordering) is ``StoragePartition.merge_segments``."""
        spec = self.spec
        dropped = 0
        for part in self.storage.partitions:
            while force or self._tokens > 0:
                run = find_merge_run(part.segment_stats(),
                                     spec.merge_fanin,
                                     spec.level_target_rows, min_run)
                if run is None:
                    break
                si, count, run_rows = run
                if not force:
                    self._tokens -= run_rows   # merges rewrite every row
                t_m = time.perf_counter()
                try:
                    n, got = part.merge_segments(si, count)
                except IndexError:
                    break    # layout moved since segment_stats(); retry
                if self._obs is not None and self._obs.tracing:
                    # under the compaction-step lock only (blocking-ok:
                    # R6-exempt, edge declared in analysis/annotations.py)
                    self._obs.emit("compact.merge", (),
                                   t0=time.monotonic(),
                                   dur=time.perf_counter() - t_m,
                                   rows=n, dropped=got, inputs=count,
                                   partition=part.pid)
                self.stats.merges += 1
                self.stats.segments_merged += count
                self.stats.rows_merged += n
                self.stats.rows_dropped += got
                self.stats.rows_rewritten += n - got
                dropped += got
        return dropped

    def merge_now(self, min_run: int = 2) -> int:
        """Synchronously merge every eligible run, ignoring the budget
        and relaxing the fanin trigger to runs of ``min_run`` segments;
        returns rows dropped.  Benchmarks, tests, and the quickstart use
        it to age a store on demand (the background scheduler does the
        same work incrementally via ``step``)."""
        with self._step_lock:
            if self.spec.level_target_rows <= 0:
                return 0
            return self._merge_pass(True, min_run=min_run)

    # -------------------------------------------------------------- drain
    def drain(self, timeout: Optional[float] = 60.0) -> bool:
        """Compact until no dead rows remain (unbudgeted); returns whether
        it got there within ``timeout``.  Under concurrent writers the
        target moves — quiesce them first for a guaranteed-zero store."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.storage.dead_rows > 0:
            if deadline is not None and time.monotonic() > deadline:
                return False
            if self.step(force=True) == 0 and self.storage.dead_rows > 0:
                # raced a writer between decide and recheck; keep going
                time.sleep(0.001)
        return True

    def finish(self, timeout: Optional[float] = 60.0) -> bool:
        """Stop the scheduler thread (feed shutdown).  No forced drain:
        compaction is an optimization, not a correctness requirement —
        callers wanting a fully-reclaimed store use ``drain()`` first."""
        self.stop()
        if self.is_alive():
            self.join(timeout)
        return self.storage.dead_rows == 0
