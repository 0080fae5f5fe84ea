"""Progressive re-enrichment (the repair subsystem): keep *stored*
enrichments current as reference data changes.

The paper's adaptiveness (Model 2) refreshes reference snapshots for
**in-flight** batches only — rows already in the column store keep
whatever enrichment was current at ingest time and silently go stale when
a ``RefTable`` is upserted.  This module closes that gap with the
pay-as-you-go re-enrichment model of PIQUE (Ghosh et al., 1805.12033),
declared — per INGESTBASE's argument (Jindal et al., 1701.06093) that
post-ingestion logic belongs in the ingestion plan — on the plan itself:

    pipeline(adapter).parse(...).enrich(Q.Q1)
        .store(refresh=RepairSpec(budget_rows_s=..., max_lag_s=...))

Four pieces:

  * **Lineage** — every stored chunk/segment records the ref-version map
    its rows were enriched under (captured at the computing job's snapshot,
    persisted in the manifest; see storage.py).
  * **Staleness index** — ``RefTable`` upsert/delete listeners publish
    (version, time, changed keys); a stored unit is stale when its lineage
    trails any subscribed table's current version.  Coarse version match
    first; where the UDF declares ``repair_keys`` (table -> probe column),
    a vectorized dirty-key probe against the stored join-key column
    refines the unit down to the rows actually affected — often to zero,
    in which case the unit's lineage is simply advanced.
  * **Repair scheduler** — this thread drains a priority queue of stale
    units (oldest staleness first), re-runs the plan's fused enrich stages
    through a ``ComputingRunner`` that SHARES the feed's ``PredeployCache``
    (same UDF identity + same padded batch shape -> the already-compiled
    executable; zero recompilation), and upserts results in place with
    ``StoragePartition.repair_rows`` — a conditional index check gives
    exactly-once semantics under concurrent ingestion (a racing ingest
    upsert always wins; re-scans are no-ops).  A token bucket caps repair
    at ``budget_rows_s`` scanned rows/s, and the scheduler *yields* while
    the feed has real ingestion backlog (or its elastic groups are scaled
    above their minimum), so repair never competes with the paper's
    primary job.  ``drain()`` runs unbudgeted after the feed ends so
    ``join()`` returns a converged store.
  * **Currency metrics** — ``RepairStats``: stale/repaired/superseded/
    refined row counts and ``repair_lag`` p50/p95 (ref upsert -> repaired
    row), surfaced through ``FeedStats`` and the fig_repair benchmark.

Semantics notes: filters are re-evaluated during repair, and a stored row
the re-evaluated filter now rejects is **deleted** from the store
(``StoragePartition.delete_rows`` — the same conditional index check as
``repair_rows``, so a concurrent ingest upsert always wins and re-scans
are no-ops; counted ``invalidated_rows``/``deleted_rows``).  Superseded
and deleted row versions accumulate append-only until compaction
(core/compaction.py) reclaims them; repair coordinates with compaction —
and with its leveled segment MERGES, which additionally dissolve unit
boundaries and re-sort rows across them — through the partition's
**layout epoch**: a unit's epoch is captured with its scan and passed
back to every conditional write, so a renumbering mid-repair rejects the
batch instead of letting a reused position number spuriously match (the
unit stays stale and is simply re-scanned).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import records
from repro_torch.core.computing import ComputingRunner, ComputingSpec
from repro_torch.core.refdata import RefStore
from repro_torch.core.storage import Lineage, StorageJob


@dataclasses.dataclass(frozen=True)
class RepairSpec:
    """Repair policy for one plan's store sink (``.store(refresh=...)``).

    ``budget_rows_s`` is the token-bucket rate of *scanned* stored rows per
    second (scan + probe + re-enrich all ride on it) — the knob trading
    freshness against ingestion interference; ``max_lag_s`` is the
    staleness SLO: while the oldest unserviced ref change is younger than
    this, repair politely yields to any ingestion backlog — once it is
    older, repair stops yielding (the budget still applies), so sustained
    backlog can delay freshness by at most ~max_lag_s; ``priority``
    orders stale units across repair jobs sharing a node (lower = first,
    tie-broken by oldest staleness)."""
    budget_rows_s: float = 10_000.0
    max_lag_s: float = 5.0
    priority: int = 0
    interval_s: float = 0.02       # scheduler cadence while events pend
    # yield while queued ingestion backlog exceeds this many batches per
    # partition.  Default 0: ANY queued frame defers repair — ingestion is
    # the primary job, repair takes the idle gaps (and the post-feed drain)
    yield_backlog_batches: float = 0.0
    # token-bucket depth: small on purpose — a deep bucket lets a step that
    # begins in a momentary idle gap (e.g. the feed's final batches) spend
    # a large accumulated burst against ingestion's last stretch
    burst_s: float = 0.05

    def __post_init__(self):
        if self.budget_rows_s <= 0 or self.max_lag_s <= 0:
            raise ValueError("budget_rows_s and max_lag_s must be > 0")
        if self.interval_s <= 0 or self.burst_s <= 0:
            raise ValueError("interval_s and burst_s must be > 0")
        if self.yield_backlog_batches < 0:
            raise ValueError("yield_backlog_batches must be >= 0")


@dataclasses.dataclass
class RepairStats:
    """Currency accounting for one feed's repair job."""
    stale_rows: int = 0          # rows found needing re-enrichment
    repaired_rows: int = 0       # rows actually upserted in place
    superseded_rows: int = 0     # skipped: a concurrent ingest upsert won
    refined_rows: int = 0        # skipped via dirty-key probe refinement
    invalidated_rows: int = 0    # re-run filter rejected the stored row
    deleted_rows: int = 0        # ... and the conditional delete applied
    units_scanned: int = 0
    units_refined: int = 0       # advanced lineage without re-enriching
    repair_invocations: int = 0  # predeployed apply calls issued
    steps: int = 0
    yields: int = 0              # cycles skipped for ingestion backlog
    repair_s: float = 0.0        # scheduler time, scan through upsert
    drain_s: float = 0.0         # post-feed convergence time (join())
    # bounded ring: newest samples win, so the percentiles track the
    # recent window instead of leaking memory on long-running feeds
    lag_samples: List[float] = dataclasses.field(default_factory=list)

    MAX_LAG_SAMPLES = 4096
    # class attr (not a dataclass field, so merge/asdict never see it):
    # optional core/obs histogram the lag samples dual-write into
    _hist = None

    def attach_histogram(self, hist) -> None:
        """Dual-write lag samples into an obs histogram (the feed's
        ``repair_currency_s``) in addition to the local ring — the
        registry number and the dataclass percentiles then come from the
        same observations, which is exactly what the benchmark's
        registry-vs-driver cross-check validates."""
        self._hist = hist

    def add_lag(self, lag: float) -> None:
        self.lag_samples.append(lag)
        if len(self.lag_samples) > self.MAX_LAG_SAMPLES:
            del self.lag_samples[:len(self.lag_samples) // 2]
        if self._hist is not None:
            # callers hold at most the repair-step lock (blocking-ok):
            # histogram observes are legal there (feedlint R6)
            self._hist.observe(lag)

    def _lag_q(self, q: float) -> float:
        if not self.lag_samples:
            return 0.0
        xs = sorted(self.lag_samples)
        return float(xs[min(len(xs) - 1, int(q * len(xs)))])

    @property
    def repair_lag_p50_s(self) -> float:
        return self._lag_q(0.50)

    @property
    def repair_lag_p95_s(self) -> float:
        return self._lag_q(0.95)


def feed_busy(handle, per_part_rows: float) -> bool:
    """The yield test the background maintenance jobs share (repair here,
    compaction in core/compaction.py): True while the feed's computing
    workers have real ingestion backlog above ``per_part_rows`` queued
    rows per partition, or any elastic group is scaled above its floor
    (the controller judged the feed busy) — ingestion is the primary job;
    background work takes the idle gaps."""
    if handle is None or handle._live_workers <= 0:
        return False                 # feed drained: nobody to yield to
    for g in list(handle.stage_groups):
        holders = list(g.holders)
        rows = sum(hh.backlog()[0] for hh in holders)
        if rows > per_part_rows * max(1, len(holders)):   # 0-threshold:
            return True                                   # any backlog
        if g.elastic is not None and \
                len(holders) > g.elastic.min_partitions:
            return True
    return False


class _RefEvent(NamedTuple):
    version: int                  # table version AFTER the write
    t: float                      # monotonic publish time (lag metric)
    keys: Optional[np.ndarray]    # changed keys; None = unknown (coalesced)


class RepairJob(threading.Thread):
    """Background repair scheduler for one feed (one thread; its
    ``ComputingRunner`` is confined to it, ``step()`` is serialized by an
    internal lock so tests and ``drain()`` may call it directly)."""

    MAX_EVENTS = 512              # per-table event log bound (coalesced)
    REFINE_MAX_KEYS = 262_144     # dirty-key union cap for the probe

    def __init__(self, plan, storage: StorageJob, refstore: RefStore,
                 predeploy=None, handle=None, device=None):
        super().__init__(name=f"{plan.name}-repair", daemon=True)
        spec = plan.store_spec.refresh
        assert spec is not None and plan.udf is not None
        self.plan = plan
        self.spec: RepairSpec = spec
        self.storage = storage
        self.refstore = refstore
        self.handle = handle      # duck-typed FeedHandle (None in tests)
        self.stats = RepairStats()
        self._obs = getattr(handle, "obs", None)
        if self._obs is not None:
            self.stats.attach_histogram(
                self._obs.registry.histogram("repair_currency_s"))
        self.error: Optional[BaseException] = None
        self._tables: Tuple[str, ...] = plan.udf.ref_tables
        # table -> ALL declared probe columns (a chain may probe one table
        # through several batch columns; a row is affected if ANY hits)
        self._probe_cols: Dict[str, Tuple[str, ...]] = {}
        for t, col in plan.udf.repair_keys:
            self._probe_cols[t] = self._probe_cols.get(t, ()) + (col,)
        # version-gated Model 2 regardless of the plan's model: repair must
        # see fresh state per changed version, at Model-3 cost when quiet
        self._runner = ComputingRunner(
            ComputingSpec(plan.udf, plan.batch_size, "per_batch", "version"),
            refstore, predeploy, device=device)
        self._events: Dict[str, List[_RefEvent]] = {t: [] for t
                                                    in self._tables}  # guarded-by: _events_lock
        self._events_lock = threading.Lock()   # lock-name: repair-events
        # serializes step(); a dedicated background lock, so blocking work
        # (scans, re-enrichment dispatch) under it is by design
        self._step_lock = threading.Lock()     # lock-name: repair-step blocking-ok
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._tokens = spec.budget_rows_s * spec.burst_s  # guarded-by: _step_lock
        self._last_refill = time.monotonic()              # guarded-by: _step_lock
        # event-driven fast path: scanning every partition's lineage units
        # is cheap but not free — skip it entirely until a ref write (or
        # new stored data racing one) can have made something stale
        # _maybe_stale is a benign monotonic hint: set lock-free by
        # writers (_on_change), consumed under the step lock; a lost
        # update only costs one extra scan pass (left unguarded on
        # purpose — see docs/CONCURRENCY.md)
        self._maybe_stale = True
        self._clean_rows = -1                             # guarded-by: _step_lock
        # arrival time of the oldest ref change not yet fully serviced
        # (cleared on a clean pass) — drives the max_lag_s SLO override
        self._oldest_pending: Optional[float] = None
        refstore.subscribe(self._tables, self._on_change)

    # -------------------------------------------------------- change intake
    def _on_change(self, table: str, version: int,
                   keys: np.ndarray) -> None:
        """RefTable listener (runs on the writer's thread — cheap)."""
        with self._events_lock:
            log = self._events[table]
            log.append(_RefEvent(version, time.monotonic(),
                                 np.asarray(keys, np.int64)))
            if len(log) > self.MAX_EVENTS:
                # coalesce the oldest half into one keyless event (refines
                # to coarse matching for that version span, never misses)
                half = log[:len(log) // 2]
                merged = _RefEvent(max(e.version for e in half),
                                   min(e.t for e in half), None)
                self._events[table] = [merged] + log[len(log) // 2:]
            if self._oldest_pending is None:
                self._oldest_pending = log[-1].t
        self._maybe_stale = True
        self._wake.set()

    # ------------------------------------------------------- durability
    SNAPSHOT_MAX_KEYS = 8192      # per-event key cap in a checkpoint

    def snapshot_events(self) -> Dict[str, List]:
        """JSON-serializable image of the per-table ref-event log for a
        coordinated checkpoint (core/durability.py).  Times are stored as
        *ages* (seconds before the snapshot) because ``time.monotonic``
        does not survive a process restart; oversized key sets degrade to
        ``None`` (coarse version matching — never misses, just probes
        less precisely)."""
        now = time.monotonic()
        with self._events_lock:
            return {
                t: [[int(e.version), max(0.0, now - e.t),
                     None if e.keys is None or
                     e.keys.size > self.SNAPSHOT_MAX_KEYS
                     else [int(k) for k in e.keys]]
                    for e in log]
                for t, log in self._events.items()}

    def restore_events(self, events: Dict[str, List]) -> None:
        """Rebuild the event log from a checkpoint image (crash-restart).
        Only called when the checkpointed ref fingerprints matched the
        current tables — otherwise recovery resets lineage and repair
        re-scans everything.  Call before ``start()``."""
        now = time.monotonic()
        with self._events_lock:
            for t, log in events.items():
                if t not in self._events:
                    continue
                self._events[t] = [
                    _RefEvent(int(v), now - float(age),
                              None if keys is None
                              else np.asarray(keys, np.int64))
                    for v, age, keys in log]
            pending = [e.t for log in self._events.values() for e in log]
            if pending:
                self._oldest_pending = min(pending)
        self._maybe_stale = True
        self._wake.set()

    def _dirty_keys(self, table: str,
                    have_version: int) -> Optional[np.ndarray]:
        """Union of keys changed since ``have_version``; None = unknown
        (coalesced history or too many keys: fall back to coarse)."""
        with self._events_lock:
            evs = [e for e in self._events[table]
                   if e.version > have_version]
        if not evs or any(e.keys is None for e in evs):
            return None
        keys = np.unique(np.concatenate([e.keys for e in evs]))
        if keys.size > self.REFINE_MAX_KEYS:
            return None
        return keys

    def _stale_since(self, table: str, have_version: int,
                     now: float) -> float:
        with self._events_lock:
            ts = [e.t for e in self._events[table]
                  if e.version > have_version]
        # no recorded event (recovered store, trimmed log): the staleness
        # is older than anything we observed — use the oldest retained
        # event, else "now" (lag 0; conservative-low but unavoidable)
        return min(ts) if ts else now

    # ----------------------------------------------------------- scheduling
    def run(self) -> None:
        while not self._stop_evt.is_set():
            self._wake.wait(self.spec.interval_s)
            self._wake.clear()
            if self._stop_evt.is_set():
                return
            try:
                self.step()
            except BaseException as e:   # surfaced by FeedHandle.join()
                self.error = e
                return

    def stop(self) -> None:
        self._stop_evt.set()
        self._wake.set()
        self.refstore.unsubscribe(self._tables, self._on_change)

    def _should_yield(self) -> bool:
        """Repair is the background job: defer while the feed is busy
        (``feed_busy`` — the contract shared with core/elasticity.py and
        the compaction job), unless the staleness SLO is breached."""
        h = self.handle
        if h is None:
            return False
        oldest = self._oldest_pending
        if oldest is not None and \
                time.monotonic() - oldest > self.spec.max_lag_s:
            # staleness SLO breached: stop deferring to ingestion (the
            # row budget still bounds how hard repair competes)
            return False
        return feed_busy(
            h, self.spec.yield_backlog_batches * self.plan.batch_size)

    def _refill(self, now: float) -> None:  # requires-lock: _step_lock
        cap = self.spec.budget_rows_s * self.spec.burst_s
        self._tokens = min(cap, self._tokens + (now - self._last_refill)
                           * self.spec.budget_rows_s)
        self._last_refill = now

    def _stale_units(self, versions: Lineage, now: float):
        """Priority queue of stale units: (priority, stale_since, partition,
        start, rows, lineage), oldest staleness first within a priority."""
        out = []
        for p in self.storage.partitions:
            for start, n, lin in p.lineage_units():
                since = None
                for t in self._tables:
                    if lin.get(t, -1) < versions[t]:
                        s = self._stale_since(t, lin.get(t, -1), now)
                        since = s if since is None else min(since, s)
                if since is not None:
                    out.append((self.spec.priority, since, p, start, n,
                                lin))
        out.sort(key=lambda u: (u[0], u[1], u[3]))
        return out

    def step(self, force: bool = False) -> int:
        """One scan/repair pass; returns rows repaired.  Synchronous and
        internally serialized, so tests and ``drain()`` call it directly.
        ``force`` ignores the budget and backlog yield (post-feed drain)."""
        with self._step_lock:
            t0 = time.perf_counter()
            now = time.monotonic()
            self.stats.steps += 1
            self._refill(now)
            if not force:
                if self._should_yield():
                    self.stats.yields += 1
                    return 0
                if self._tokens <= 0:
                    return 0
            # fast path: nothing can be stale — no ref write since the
            # last clean pass AND no new rows landed (a batch enriched
            # under pre-write versions may be written after a clean pass,
            # so row growth re-arms the scan)
            rows_now = sum(p.rows_total for p in self.storage.partitions)
            if not force and not self._maybe_stale and \
                    rows_now == self._clean_rows:
                return 0
            # clear BEFORE reading versions: a write racing this pass
            # re-arms the flag via its listener, so a clean verdict below
            # can never swallow a concurrent upsert (lost wake-up)
            self._maybe_stale = False
            versions = {t: self.refstore[t].version for t in self._tables}
            units = self._stale_units(versions, now)
            if not units:
                self._clean_rows = rows_now
                self._oldest_pending = None      # every change serviced
                return 0
            # stale work found (some may stay unprocessed under the
            # budget): keep scanning on subsequent steps
            self._maybe_stale = True
            repaired = 0
            for i, (_, since, p, start, n, lin) in enumerate(units):
                if not force and self._tokens <= 0:
                    break
                if not force and i and self._should_yield():
                    # backlog built mid-step: stop after the current unit
                    # so a step begun in an idle gap can't ride through a
                    # fresh burst of ingestion work
                    self.stats.yields += 1
                    break
                self._tokens -= n        # scanned rows consume budget
                repaired += self._repair_unit(p, start, n, lin, versions,
                                              since)
            self.stats.repair_s += time.perf_counter() - t0
            return repaired

    # ------------------------------------------------------------- repair
    def _repair_unit(self, part, start: int, n: int, lin: Lineage,
                     versions: Lineage, since: float) -> int:
        # layout-epoch capture: every conditional write below carries this
        # epoch, so a compaction or leveled merge that renumbers the
        # position space between the scan and the write rejects the batch
        # (position numbers freed by a shrink are reused by later appends
        # — without the epoch a stale positional check could spuriously
        # match; a merge additionally re-sorts rows ACROSS old unit
        # boundaries, so even a count-preserving merge moves them).  The
        # rejected unit keeps its old lineage, stays stale, and is
        # re-scanned.
        epoch = part.epoch
        t_unit = time.perf_counter()
        try:
            batch = part.read_rows(start, n)
        except IndexError:
            return 0          # compaction/merge shrank the partition
        if int(batch["id"].shape[0]) != n:
            # the unit list predates a compaction or merge: the span now
            # covers fewer rows (a merge also dissolves the boundary
            # itself).  Skip — the next step re-lists current units.
            return 0
        self.stats.units_scanned += 1
        stale_tables = [t for t in self._tables
                        if lin.get(t, -1) < versions[t]]
        # dirty-key refinement: only when EVERY stale table declares probe
        # columns ALL present in the stored rows AND has known dirty keys;
        # a row is affected when ANY of a table's probe columns hits
        mask = None
        for t in stale_tables:
            cols = self._probe_cols.get(t, ())
            keys = (self._dirty_keys(t, lin.get(t, -1))
                    if cols and all(c in batch for c in cols) else None)
            if keys is None:
                mask = None
                break
            for col in cols:
                hit = np.isin(np.asarray(batch[col], np.int64), keys)
                mask = hit if mask is None else (mask | hit)
        if mask is None:
            mask = np.ones(n, bool)
        elif not mask.any():
            self.stats.units_refined += 1
            self.stats.refined_rows += n
            part.update_lineage(start, n, versions, expect_epoch=epoch)
            return 0
        self.stats.stale_rows += int(mask.sum())
        self.stats.refined_rows += int(n - mask.sum())
        rows = np.arange(start, start + n)[mask]
        # the runner must see exactly the feed-time operand signature
        # (schema columns + valid) so the predeployed apply is a cache HIT
        sub_all = {k: np.asarray(batch[k])[mask]
                   for k in (*records.TWEET_SCHEMA, "valid")}
        repaired = 0
        bs = self.plan.batch_size
        for lo in range(0, int(mask.sum()), bs):
            m = min(bs, int(mask.sum()) - lo)
            sub = {k: v[lo:lo + m] for k, v in sub_all.items()}
            out = self._runner.run(sub)
            self.stats.repair_invocations += 1
            out = {k: v[:m] for k, v in out.items()}
            keep = np.asarray(out["valid"], bool)
            if not keep.all():
                # filter-delete: re-enrichment made these stored rows fail
                # the plan's re-evaluated filter — delete them, with the
                # same conditional-index exactly-once contract as repair
                # (a racing ingest upsert wins and the row survives as its
                # newer version, to be re-scanned)
                self.stats.invalidated_rows += int(m - keep.sum())
                self.stats.deleted_rows += part.delete_rows(
                    np.asarray(sub["id"])[~keep], rows[lo:lo + m][~keep],
                    expect_epoch=epoch)
            if not keep.any():
                continue
            fixed = self.plan.restrict({k: v[keep]
                                        for k, v in out.items()})
            fixed["valid"] = np.ones(int(keep.sum()), bool)
            got = part.repair_rows(fixed, rows[lo:lo + m][keep], versions,
                                   expect_epoch=epoch)
            self.stats.superseded_rows += int(keep.sum()) - got
            repaired += got
        part.update_lineage(start, n, versions, expect_epoch=epoch)
        self.stats.repaired_rows += repaired
        if repaired:
            self.stats.add_lag(max(0.0, time.monotonic() - since))
        if self._obs is not None and self._obs.tracing:
            # under the repair-step lock only (blocking-ok: R6-exempt,
            # ordering edge declared in analysis/annotations.py)
            self._obs.emit("repair.unit", (), t0=time.monotonic(),
                           dur=time.perf_counter() - t_unit, rows=n,
                           repaired=repaired, partition=part.pid)
        return repaired

    # -------------------------------------------------------------- drain
    def converged(self) -> bool:
        versions = {t: self.refstore[t].version for t in self._tables}
        return not self._stale_units(versions, time.monotonic())

    def drain(self, timeout: Optional[float] = 60.0) -> bool:
        """Repair to convergence (no stale units against current versions),
        unbudgeted — called by ``FeedHandle.join`` after the last computing
        worker, so a joined feed hands back a current store.  Returns
        whether it converged within ``timeout``.  Convergence is checked
        against the *current* versions each pass: if reference tables keep
        changing while draining, the target moves and ``timeout`` is the
        only bound — quiesce writers before join() for a guaranteed-final
        store (benchmarks/fig_repair.py's ``join_quiesced``)."""
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        try:
            while not self._stop_evt.is_set():
                if self.converged():
                    return True
                if deadline is not None and time.monotonic() > deadline:
                    return False
                self.step(force=True)
            return self.converged()
        finally:
            self.stats.drain_s += time.monotonic() - t0

    def finish(self, timeout: Optional[float] = 60.0) -> bool:
        """Drain, stop, and join the scheduler thread (feed shutdown)."""
        converged = self.drain(timeout)
        self.stop()
        if self.is_alive():
            self.join(timeout)
        return converged
