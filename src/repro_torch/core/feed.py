"""The Active Feed Manager (§7.1): executes declarative ingestion plans.

The primary entry point is the **plan API** (core/plan.py):

    plan = (pipeline(adapter, "tweets").parse(batch_size=420)
            .enrich(Q.Q1).enrich(Q.Q2)          # fused: ONE apply per batch
            .filter(pred).project("safety_level", ...)
            .tee(lm_sink).store(spill_dir=...))  # multi-sink fan-out
    handle = manager.submit(plan)                # -> FeedHandle

``submit`` wires the compiled plan onto the three-job pipeline of Fig 23:

    intake job  ->  [passive intake holders]  ->  computing workers
                ->  [one active sink holder PER SINK]  ->  storage job
                                                        / tee consumers

and keeps invoking computing jobs while data flows (a worker loop per
partition — each ``ComputingRunner.run`` call is one computing-job
invocation, counted and timed, with per-stage ``ComputingStats`` for fused
chains).  Every enriched batch is pushed to every sink holder exactly once;
each sink drains its own bounded queue, so one slow sink backpressures the
feed without corrupting another sink's delivery.  Stop protocol per §7.1:
the adapter ends, the intake job enqueues StopRecords, computing workers
drain and finish partial batches, the sink holders close after the last
worker.  Completed feeds deregister from the manager (name + holder IDs
become reusable).

**Baselines:** ``FeedManager.start(FeedConfig(...), adapter)`` is now the
entry point for the paper-baseline measurement rigs ONLY; the deprecated
framework="new" shim lowering was removed once every driver migrated to
plans (``FeedConfig`` survives as the internal runtime config a compiled
plan lowers onto).  The baseline frameworks stay cfg-only (they are
measurement rigs, not plans):

  framework="current"   coupled single job, single parsing node, Model-3
                        state (AsterixDB data feeds with a Java UDF)
  framework="balanced"  coupled, parsing divided over all nodes
  framework="insert"    Approach 1: repeated INSERT statements — every
                        batch pays query compilation (no predeploy cache)
  framework="new"       this paper: decoupled + predeployed + Model 2 —
                        plan-only; ``start`` rejects it

Fault tolerance: per-invocation retry with exponential backoff; failed
frames are re-enqueued (at-least-once) and the idempotent storage job makes
delivery effectively exactly-once.  Idle workers steal from the deepest
holder (straggler mitigation).

**Per-stage elasticity** (core/elasticity.py): a compiled plan is >= 1
linked **stage groups** — chain segments split at declared boundaries
(``.enrich(q6, partitions=..., elastic=...)``), each with its own holder
list + worker pool + elastic bounds, connected by intermediate
``PartitionHolder``s so a heavy-state stage (Q6) scales independently of
cheap probe stages.  ``FeedHandle.scale_up(n, stage=g)`` adds partitions
mid-feed (the upstream round-robin re-targets); ``scale_down`` retires
them — the holder leaves the round-robin under the handle lock, a
StopRecord drains its queue exactly-once, and the worker merges its
``ComputingStats`` into the feed totals as it exits.  With
``options(elastic=...)`` an ``ElasticityController`` thread closes the
loop from observed backlog (rows + bytes queued per group) to partition
count between ``min_partitions``/``max_partitions``.

Cross-partition micro-batching (``coalesce_rows``): when a worker finds
a backlog in its holder it coalesces queued frames — up to a row AND byte
budget — into ONE kernel dispatch.  Per-invocation overhead (snapshot
lookup, H2D, executable dispatch) is paid once per coalesced batch instead
of once per frame, which is the paper's batch-size lever (Fig 25/26)
applied adaptively: an idle feed keeps per-frame latency, a backlogged feed
converges to throughput-optimal batches.  Coalesced batches are padded to
power-of-two row buckets (enrich/dispatch.py) so they never trigger
per-size recompiles.  Default (``coalesce_rows=None``): ON at 4x the batch
size for the decoupled framework, OFF for the baselines (whose per-batch
cost model the coalescer would distort).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import DeviceLike, kernels, resolve_device
from repro_torch.core import records
from repro_torch.core.compaction import CompactionJob, CompactionStats
from repro_torch.core.computing import ComputingRunner, ComputingSpec, \
    ComputingStats
from repro_torch.core.durability import DurabilityRuntime
from repro_torch.core.elasticity import ElasticityController, ElasticSpec
from repro_torch.core.enrich.queries import EnrichUDF
from repro_torch.core.intake import Adapter, IntakeJob, TrackedBatch, TrackedFrame
from repro_torch.core.obs import (FeedHealthModel, FeedObs, HealthReport,
                            JourneyProfiler, MetricValue, ObsServer,
                            ProfileReport, ROWS_BOUNDS, TraceSpec, mangle,
                            write_jsonl)
from repro_torch.core.partition_holder import (ActivePartitionHolder,
                                         PartitionHolder,
                                         PartitionHolderManager,
                                         StopRecord, frame_bytes,
                                         frame_rows)
from repro_torch.core.plan import IngestPlan, Pipeline, StageGroup
from repro_torch.core.predeploy import PredeployCache
from repro_torch.core.refdata import RefStore
from repro_torch.core.repair import RepairJob, RepairStats
from repro_torch.core.storage import StorageJob

# coalesce_rows=None resolves to this many batches' worth of rows for the
# decoupled framework
COALESCE_DEFAULT_BATCHES = 4


def _store_consumer(storage: StorageJob, ledger=None, obs=None) -> Callable:
    """Storage-sink consumer: unwrap lineage-tagged batches (plan path);
    bare dicts (pure-ingestion / legacy call sites) store unversioned.
    On durable feeds the consumer marks the batch's WAL sequence numbers
    done in the ledger AFTER the (idempotent) store write returns — that
    ordering is the exactly-once contract: a checkpoint can only cite a
    watermark whose records are already in the column store.

    Currency accounting (core/obs): once the write returns the rows are
    snapshot-queryable, so this is where store-visible latency — the
    paper's lag metric, intake stamp to queryable — lands in the
    ``ingest_visible_latency_s`` histogram, and where the ``store.append``
    span closes a traced batch's journey.  Both happen with no lock held
    (this thread is the sink holder's drain loop)."""
    lat_hist = (obs.registry.histogram("ingest_visible_latency_s")
                if obs is not None else None)

    def consume(frame) -> None:
        if isinstance(frame, _StoreBatch):
            t0 = time.perf_counter()
            storage.write(frame.batch, lineage=frame.lineage,
                          span_ids=frame.span_ids)
            if ledger is not None and frame.wal_seqs:
                ledger.mark_done(frame.wal_seqs)
            if obs is not None:
                dur = time.perf_counter() - t0
                now = time.monotonic()
                if frame.t_intake:
                    lat_hist.observe(max(0.0, now - frame.t_intake))
                if frame.span_ids:
                    obs.emit("store.append", frame.span_ids, t0=now - dur,
                             dur=dur, rows=_frame_rows(frame.batch))
        else:
            storage.write(frame)
            if ledger is not None:
                seqs = getattr(frame, "wal_seqs", None)
                if seqs:
                    ledger.mark_done(seqs)
    return consume

_frame_rows = frame_rows      # shared with the holders' backlog accounting
_frame_bytes = frame_bytes


class _StoreBatch:
    """An enriched batch plus the ref-version lineage it was computed
    under, en route to the STORE sink holder (tee sinks receive the bare
    dict).  The storage job records the lineage per stored chunk so the
    repair subsystem (core/repair.py) can find stale rows later.  On
    durable feeds ``wal_seqs`` carries the intake-log sequence numbers of
    the raw frames this batch was parsed from (core/durability.py);
    ``span_ids``/``t_intake`` are the observability stamps lifted off the
    raw ``TrackedFrame`` the same way (core/obs — span ids close the
    trace at the store, the intake timestamp prices store-visible
    latency)."""
    __slots__ = ("batch", "lineage", "wal_seqs", "span_ids", "t_intake")

    def __init__(self, batch: Dict, lineage: Optional[Dict[str, int]],
                 wal_seqs: Optional[Tuple[int, ...]] = None,
                 span_ids: Tuple[int, ...] = (), t_intake: float = 0.0):
        self.batch = batch
        self.lineage = lineage
        self.wal_seqs = wal_seqs
        self.span_ids = span_ids
        self.t_intake = t_intake


@dataclasses.dataclass
class FeedConfig:
    """Runtime feed configuration.

    Historically the whole public surface (one ``udf`` slot, one sink) and
    once a ``start``-time shim over the plan API; the shim lowering is
    gone.  Today it serves two roles: the internal config a compiled
    ``IngestPlan`` lowers onto in ``FeedManager.submit``, and the driver
    config of the paper-baseline measurement rigs
    (framework="current"/"balanced"/"insert" via ``FeedManager.start``).
    Decoupled feeds are built with ``pipeline(...)``/``submit``."""
    name: str = "feed"
    udf: Optional[EnrichUDF] = None
    batch_size: int = 420                 # the paper's 1X
    num_partitions: int = 1
    model: str = "per_batch"              # per_record | per_batch | stream
    refresh: str = "always"               # always | version
    framework: str = "new"                # new | current | balanced | insert
    storage_partitions: int = 0           # 0 -> num_partitions
    spill_dir: Optional[str] = None
    upsert: bool = False
    work_stealing: bool = True
    max_retries: int = 3
    retry_backoff_s: float = 0.05
    holder_capacity: int = 8
    # cross-partition micro-batching: coalesce queued frames into one
    # computing-job invocation up to this many rows (0 disables) and
    # coalesce_bytes raw bytes.  None = auto: COALESCE_DEFAULT_BATCHES x
    # batch_size for framework="new", 0 for the baselines.  Ignored for
    # model="per_record", whose semantics are inherently per-row.
    coalesce_rows: Optional[int] = None
    coalesce_bytes: int = 8 << 20
    # test hook: raises inside the computing job when it returns True
    fault_hook: Optional[Callable[[int], bool]] = None
    # alternate sink: enriched batches go to this callable instead of the
    # storage job (the LM data plane consumes batches directly — see
    # train/data_feed.py)
    sink: Optional[Callable[[Dict], None]] = None
    # feed-wide elastic bounds (shim lowering of options(elastic=...));
    # per-stage bounds are plan-only
    elastic: Optional[ElasticSpec] = None

    @property
    def resolved_coalesce_rows(self) -> int:
        if self.coalesce_rows is not None:
            return self.coalesce_rows
        if self.framework == "new":
            return COALESCE_DEFAULT_BATCHES * self.batch_size
        return 0


# FeedStats scalar fields backed by the metrics registry once bound:
# integer event counts become counters, float durations/levels gauges.
# Mutation sites keep their existing synchronization (the handle lock) —
# counter/gauge updates are plain attribute writes, explicitly legal under
# core locks (feedlint R6 flags only histogram observe / span emit there).
_FEED_COUNTER_FIELDS = ("records_in", "frames_in", "stored", "retries",
                        "steals", "coalesced_frames", "scale_ups",
                        "scale_downs", "stale_rows", "repaired_rows",
                        "compacted_rows")
_FEED_GAUGE_FIELDS = ("wall_s", "storage_write_s", "worker_seconds",
                      "backlog_p95_rows", "repair_lag_p50_s",
                      "repair_lag_p95_s", "repair_drain_s",
                      "durable_finish_s")
_FEED_SCALAR_FIELDS = frozenset(_FEED_COUNTER_FIELDS + _FEED_GAUGE_FIELDS)


@dataclasses.dataclass
class FeedStats:
    """Feed-level stats.  The attribute API below is the stable public
    surface; once ``bind()`` attaches a ``MetricsRegistry`` (every
    ``FeedHandle`` does this at construction) the scalar fields are
    *views over registry instruments* — reads and writes go through the
    feed's ``feed_<field>`` counter/gauge, so ``handle.metrics()`` and
    the Prometheus exposition see the same live numbers benchmarks read
    off this dataclass.  Unbound instances (direct construction in
    tests) behave exactly like the plain dataclass they look like."""
    wall_s: float = 0.0
    records_in: int = 0
    frames_in: int = 0
    stored: int = 0
    retries: int = 0
    steals: int = 0
    coalesced_frames: int = 0     # frames merged into a neighbor's batch
    computing: ComputingStats = dataclasses.field(
        default_factory=ComputingStats)
    predeploy: Dict = dataclasses.field(default_factory=dict)
    storage_write_s: float = 0.0
    # multi-sink fan-out: sink name -> batches delivered (exactly-once per
    # sink per enriched batch)
    sink_batches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # elasticity: partition add/retire events (manual + controller), the
    # integral of live computing workers over time (the cost side of the
    # elastic-vs-static A/B), and per-group peak partition counts
    scale_ups: int = 0
    scale_downs: int = 0
    worker_seconds: float = 0.0
    backlog_p95_rows: float = 0.0
    peak_partitions: Dict[str, int] = dataclasses.field(default_factory=dict)
    # progressive re-enrichment (core/repair.py): currency of stored rows
    # under mid-/post-ingestion reference updates.  repair_drain_s is the
    # post-feed convergence time join() spent, so benchmarks can separate
    # ingest-side throughput from the repair catch-up.
    stale_rows: int = 0
    repaired_rows: int = 0
    repair_lag_p50_s: float = 0.0
    repair_lag_p95_s: float = 0.0
    repair_drain_s: float = 0.0
    repair: Optional[RepairStats] = None
    # durable feeds (core/durability.py): time join() spent in the final
    # coordinated checkpoint (WAL sync + storage flush + snapshot +
    # truncate) — shutdown drain, not steady-state ingest, so benchmarks
    # can exclude it the way they exclude repair_drain_s
    durable_finish_s: float = 0.0
    # background segment compaction (core/compaction.py): space reclaimed
    # from superseded/deleted row versions while the feed ran
    compacted_rows: int = 0
    compaction: Optional[CompactionStats] = None

    @property
    def records_per_s(self) -> float:
        return self.records_in / self.wall_s if self.wall_s else 0.0

    # ------------------------------------------------- registry backing
    def bind(self, registry) -> None:
        """Back every scalar field with a ``feed_<name>`` instrument in
        ``registry``; current values carry over.  Nested stats objects
        (``computing``, ``repair``, ...) stay plain — the handle publishes
        them into the registry at ``metrics()`` collect time instead."""
        inst: Dict[str, object] = {}
        for f in _FEED_COUNTER_FIELDS:
            c = registry.counter("feed_" + f)
            c.set(getattr(self, f))
            inst[f] = c
        for f in _FEED_GAUGE_FIELDS:
            g = registry.gauge("feed_" + f)
            g.set(getattr(self, f))
            inst[f] = g
        # installed LAST: its presence is what flips the access paths
        self.__dict__["_inst"] = inst

    def __getattribute__(self, name: str):
        if name in _FEED_SCALAR_FIELDS:
            inst = object.__getattribute__(self, "__dict__").get("_inst")
            if inst is not None:
                return inst[name].value
        return object.__getattribute__(self, name)

    def __setattr__(self, name: str, value) -> None:
        if name in _FEED_SCALAR_FIELDS:
            inst = self.__dict__.get("_inst")
            if inst is not None:
                inst[name].set(value)
                return
        object.__setattr__(self, name, value)


class _WorkerSlot:
    """One computing worker: its holder, thread-confined runner, thread,
    and retirement flag (scale_down sets it; the worker then drains its
    queue, merges its stats, and exits without stealing)."""
    __slots__ = ("pid", "holder", "runner", "thread", "retire", "t_start")

    def __init__(self, pid: int, holder: PartitionHolder,
                 runner: ComputingRunner):
        self.pid = pid
        self.holder = holder
        self.runner = runner
        self.thread: Optional[threading.Thread] = None
        self.retire = threading.Event()
        self.t_start = time.perf_counter()


class _StageGroupRuntime:
    """Runtime state of one compiled ``StageGroup``: its own holder list
    (round-robin target of the upstream job), worker pool, computing spec
    derived from the plan, and elastic bounds.  All mutation happens under
    the feed handle's lock."""

    def __init__(self, gid: int, name: str, job: str, spec: ComputingSpec,
                 elastic: Optional[ElasticSpec]):
        self.gid = gid
        self.name = name
        self.job = job              # holder-manager job name (stealing)
        self.spec = spec
        self.elastic = elastic
        self.holders: List[PartitionHolder] = []   # live, lock-guarded
        self.slots: List[_WorkerSlot] = []
        self.next: Optional["_StageGroupRuntime"] = None
        self.next_pid = 0           # monotonic: retired pids never reused
        self.live = 0
        self.rr = 0                 # round-robin cursor into next.holders
        self.closing = False        # upstream drained: no more scale-ups
        self.peak_partitions = 0


class FeedHandle:
    def __init__(self, cfg: FeedConfig, manager: "FeedManager",
                 adapter: Adapter, plan: Optional[IngestPlan] = None):
        self.cfg = cfg
        self.plan = plan            # None for the cfg-only baseline paths
        self.manager = manager
        self.adapter = adapter
        self.storage: Optional[StorageJob] = None
        self.intake: Optional[IntakeJob] = None
        self.holders: List[PartitionHolder] = []
        self.workers: List[threading.Thread] = []
        self.runners: List[ComputingRunner] = []
        # decoupled path: >= 1 linked stage groups (per-stage parallelism);
        # empty for the coupled/insert baselines
        self.stage_groups: List[_StageGroupRuntime] = []
        self.controller: Optional[ElasticityController] = None
        # one active holder per sink (plan fan-out); storage_holder aliases
        # the first for pre-plan call sites
        self.sink_holders: List[ActivePartitionHolder] = []
        self._sink_names: List[str] = []
        self._store_sink_idx: Optional[int] = None
        self.storage_holder: Optional[ActivePartitionHolder] = None
        self.repair: Optional[RepairJob] = None
        self.compaction: Optional[CompactionJob] = None
        self.durability: Optional[DurabilityRuntime] = None
        # observability (core/obs): metrics are ALWAYS on — counters and
        # gauges are plain attribute writes, histograms a tiny per-
        # instrument lock — while span tracing is opt-in (plan trace=...).
        # FeedStats scalars read/write through this registry from birth.
        self.obs = FeedObs()
        self.stats = FeedStats()
        self.stats.bind(self.obs.registry)
        # currency + backlog histograms exist from birth so metrics()
        # always carries the keys, observed or not
        self._lat_hist = self.obs.registry.histogram(
            "ingest_visible_latency_s")
        self._repair_hist = self.obs.registry.histogram("repair_currency_s")
        self._backlog_hist = self.obs.registry.histogram(
            "backlog_rows", ROWS_BOUNDS)
        self._backlog_age_hist = self.obs.registry.histogram(
            "holder_backlog_age_s")
        # feedscope (core/obs): journey profiler (opt-in via
        # options(profile=...)), SLO health model (lazy — see health()),
        # and their always-present instruments: the worker_errors counter
        # feeds the health rule of the same name, feed_health publishes
        # the verdict (0 ok / 1 degraded / 2 stalled)
        self.profiler: Optional[JourneyProfiler] = None
        self._health_model: Optional[FeedHealthModel] = None
        self._health_gauge = self.obs.registry.gauge("feed_health")
        self._worker_err_counter = self.obs.registry.counter("worker_errors")
        self._t0 = 0.0
        self._lock = threading.Lock()               # lock-name: handle
        # appended by worker threads under the lock; read lock-free from
        # join() only after every worker thread has exited
        self._worker_errs: List[BaseException] = []  # write-guarded-by: _lock
        self._invocation_counter = 0                 # guarded-by: _lock
        self._live_workers = 0                       # guarded-by: _lock
        self._finalized = False
        self._deregistered = False
        self._sinks_dead = False    # all sink consumers failed: discard
        # ComputingStats of workers retired by scale_down, merged here the
        # moment the worker exits so no invocation/record count can vanish
        # merged under the lock at worker exit; read lock-free by
        # _finalize() after join() proved all workers are gone
        self._retired_computing = ComputingStats()  # write-guarded-by: _lock

    # ------------------------------------------------------------- lifecycle
    def stop(self) -> None:
        """Graceful stop: stop the adapter; the drain protocol finishes the
        in-flight batches (§7.1)."""
        self.adapter.stop()

    def join(self, timeout: Optional[float] = None) -> FeedStats:
        if self.intake is not None:
            self.intake.join(timeout)
        for w in self.workers:     # the list may grow while we iterate
            w.join(timeout)        # (scale_up); appended threads are seen
        if self.controller is not None:
            self.controller.stop()
            self.controller.join(timeout)
        try:
            if not self._finalized:
                for sh in self.sink_holders:
                    # last computing job done -> sinks stop
                    sh.close()
                sink_err: Optional[BaseException] = None
                for sh in self.sink_holders:
                    try:
                        # join EVERY sink before raising: healthy sinks
                        # must finish draining even when another failed
                        sh.join(timeout)
                    except BaseException as e:
                        sink_err = sink_err or e
                if sink_err is not None:
                    raise sink_err
            if self._worker_errs:
                raise self._worker_errs[0]
            if self.intake is not None and self.intake.error is not None:
                raise self.intake.error
            if self.repair is not None and not self._finalized:
                # the feed's own work is done: repair the remaining stale
                # segments to convergence so join() hands back a store
                # that is current against the final reference versions
                self.repair.finish(timeout)
                if self.repair.error is not None:
                    raise self.repair.error
            if self.compaction is not None and not self._finalized:
                # stop (no forced drain: compaction is an optimization —
                # callers wanting a fully-reclaimed store call
                # handle.compaction.drain() / storage.compact() first)
                self.compaction.finish(timeout)
                if self.compaction.error is not None:
                    raise self.compaction.error
            if self.durability is not None and not self._finalized:
                # final coordinated checkpoint: flush, snapshot the
                # watermark (== last seq once every sink drained), and
                # truncate the intake log so a clean restart replays
                # nothing
                t_fin = time.perf_counter()
                self.durability.finish(timeout)
                self.stats.durable_finish_s = (time.perf_counter()
                                               - t_fin)
            self._finalize()
        finally:
            if self.repair is not None:
                self.repair.stop()      # idempotent; error paths too
            if self.compaction is not None:
                self.compaction.stop()
            if self.durability is not None:
                self.durability.stop()  # idempotent; error paths too
            self._deregister()
        return self.stats

    def _finalize(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        self.stats.wall_s = time.perf_counter() - self._t0
        if self.intake is not None:
            self.stats.records_in = self.intake.records_in
            self.stats.frames_in = self.intake.frames_in
        if self.storage is not None:
            self.stats.stored = self.storage.stored
            self.stats.storage_write_s = self.storage.write_s
        # retired workers merged their runners at exit (scale_down); the
        # runners list holds only never-retired workers at this point
        self.stats.computing.merge(self._retired_computing)
        for r in self.runners:
            self.stats.computing.merge(r.stats)
        for g in self.stage_groups:
            self.stats.peak_partitions[g.name] = g.peak_partitions
        # every worker pull samples queue depth into the registry, so the
        # p95 reports for STATIC feeds too (it used to exist only while
        # an elasticity controller was sampling); an elastic feed's
        # controller ring still refines it — worst across all stage
        # groups, since group 0's backlog can describe the wrong pool
        p95 = self._backlog_hist.percentile(0.95)
        # empty-histogram percentiles are nan by design (core/obs): an
        # idle feed's summary stat stays the neutral 0.0
        self.stats.backlog_p95_rows = p95 if p95 == p95 else 0.0
        if self.controller is not None:
            self.stats.backlog_p95_rows = max(
                self.stats.backlog_p95_rows,
                max((self.controller.backlog_p95(g.gid)
                     for g in self.stage_groups), default=0.0))
        spec = self.obs.trace_spec
        if spec is not None and spec.path:
            with open(spec.path, "a", encoding="utf-8") as fp:
                write_jsonl(self.obs.drain_trace(), fp)
        for name, sh in zip(self._sink_names, self.sink_holders):
            self.stats.sink_batches[name] = sh.pulled
        if self.repair is not None:
            r = self.repair.stats
            self.stats.repair = r
            self.stats.stale_rows = r.stale_rows
            self.stats.repaired_rows = r.repaired_rows
            self.stats.repair_lag_p50_s = r.repair_lag_p50_s
            self.stats.repair_lag_p95_s = r.repair_lag_p95_s
            self.stats.repair_drain_s = r.drain_s
        if self.compaction is not None:
            self.stats.compaction = self.compaction.stats
            self.stats.compacted_rows = self.compaction.stats.rows_dropped
        self.stats.predeploy = self.manager.predeploy.stats()

    def _deregister(self) -> None:
        """Release the feed's name and holder IDs once every thread is done
        so the same feed name can be started again (restart-after-stop)."""
        if self._deregistered:
            return
        if any(w.is_alive() for w in self.workers):
            return
        if self.intake is not None and self.intake.is_alive():
            return
        if any(sh._thread.is_alive() for sh in self.sink_holders):
            return
        self._deregistered = True
        hm = self.manager.holder_manager
        all_holders: List[PartitionHolder] = list(self.sink_holders)
        if self.stage_groups:
            for g in self.stage_groups:   # retired holders already
                all_holders.extend(g.holders)  # unregistered at retire time
        else:
            all_holders.extend(self.holders)
        for h in all_holders:
            hm.unregister(h.holder_id)
        with self.manager._lock:
            if self.manager.feeds.get(self.cfg.name) is self:
                del self.manager.feeds[self.cfg.name]

    # --------------------------------------------------------------- queries
    def query(self):
        """Analytical queries over the feed's column store (core/query.py):
        ``handle.query().where(col(...) >= v).group_by(k).agg(...)
        .execute()``.  Snapshot-consistent, so it is safe — and the point —
        to call while the feed is still ingesting and repair/compaction
        are churning rows."""
        if self.storage is None:
            raise RuntimeError(
                "feed has no store sink: end the plan with .store(...) to "
                "get a queryable column store")
        return self.storage.query()

    def _note_worker_err(self, e: BaseException) -> None:
        """Record a worker-loop failure: the exception for join() to
        re-raise, plus the ``worker_errors`` counter the health model's
        rule of the same name watches."""
        with self._lock:
            self._worker_errs.append(e)
        self._worker_err_counter.inc()

    # ---------------------------------------------------------- observability
    def metrics(self) -> Dict[str, MetricValue]:
        """Live, isolated snapshot of every feed metric: counters (int),
        gauges (float), histograms (``HistogramSnapshot`` with
        ``count``/``sum``/``percentile(q)``).  The paper's currency
        numbers are native histograms here —
        ``metrics()["ingest_visible_latency_s"]`` (intake stamp →
        store-queryable) and ``["repair_currency_s"]`` (ref write → row
        repaired) — live during ingestion, not just after join()."""
        self._collect_metrics()
        return self.obs.registry.snapshot()

    def metrics_text(self) -> str:
        """Prometheus-style text exposition of ``metrics()``."""
        self._collect_metrics()
        return self.obs.registry.exposition()

    def drain_trace(self):
        """Drain and return the batch trace spans collected so far (empty
        unless the plan enabled ``options(trace=...)``); see
        docs/OBSERVABILITY.md for the span taxonomy."""
        return self.obs.drain_trace()

    def profile(self) -> Optional[ProfileReport]:
        """feedscope: drain the tracer into the journey profiler and
        return the rolling critical-path report — per-hop service/queue
        percentiles, critical-path fractions, and the ranked bottleneck
        verdict (core/obs/profile.py).  ``None`` unless the plan enabled
        ``options(profile=...)``.  As a side effect the verdict lands in
        the registry as ``bottleneck_<hop>_frac`` gauges, so ``/metrics``
        scrapes carry the attribution without a JSON round trip."""
        prof = self.profiler
        if prof is None:
            return None
        prof.ingest(self.obs.drain_trace())
        report = prof.report()
        reg = self.obs.registry
        for hop, frac in report.ranked:
            reg.gauge(mangle(f"bottleneck_{hop}_frac")).set(frac)
        return report

    def health(self) -> HealthReport:
        """feedscope: evaluate the feed's SLO rules (core/obs/health.py)
        against the current metrics snapshot and return the report; the
        verdict also lands in the ``feed_health`` gauge (0 ok / 1
        degraded / 2 stalled).  The model is created lazily from the
        plan's ``options(health=...)`` spec (defaults when absent) and
        inherits the repair SLO (``RepairSpec.max_lag_s``) when the
        store declared one."""
        with self._lock:
            model = self._health_model
            if model is None:
                max_lag = None
                if (self.plan is not None and
                        self.plan.store_spec is not None and
                        self.plan.store_spec.refresh is not None):
                    max_lag = self.plan.store_spec.refresh.max_lag_s
                spec = self.plan.health if self.plan is not None else None
                model = self._health_model = FeedHealthModel(
                    spec, max_lag_s=max_lag)
        # evaluate OUTSIDE the handle lock: metrics() touches holder and
        # instrument locks and must never nest under `handle`
        report = model.evaluate(self.metrics())
        self._health_gauge.set(float(report.code))
        return report

    def _collect_metrics(self) -> None:
        """Refresh the published-on-read surfaces: nested stats objects
        and module-level telemetry are folded into registry instruments
        here, so each metrics()/exposition read is current.  Reads are
        lock-free by design (the counters are single-writer or advisory;
        see docs/CONCURRENCY.md 'racy by design')."""
        reg = self.obs.registry
        comp = ComputingStats()
        comp.merge(self._retired_computing)
        for r in list(self.runners):
            comp.merge(r.stats)
        reg.set_counters({
            "computing_invocations": comp.invocations,
            "computing_records": comp.records,
            "computing_state_builds": comp.state_builds,
            "computing_state_reuses": comp.state_reuses,
            "computing_calibrations": comp.calibrations})
        reg.set_gauges({
            "computing_parse_s": comp.parse_s,
            "computing_upload_s": comp.upload_s,
            "computing_convert_s": comp.convert_s,
            "computing_state_s": comp.state_s,
            "computing_apply_s": comp.apply_s})
        for sname, ss in comp.per_stage.items():
            reg.set_gauges({mangle(f"stage_{sname}_apply_s"): ss.apply_s})
            reg.set_counters(
                {mangle(f"stage_{sname}_invocations"): ss.invocations})
        # kernel-dispatch routing (process-wide, repro_torch.kernels)
        for (op, path), n in kernels.path_stats().items():
            reg.counter(mangle(f"dispatch_path_{op}_{path}")).set(n)
        for g in self.stage_groups:
            reg.gauge(mangle(f"elastic_partitions_{g.name}")).set(
                len(g.holders))
        # instantaneous queued rows across every live holder (stage
        # groups + sink queues) — the health model's stall/growth signal;
        # each backlog() read takes only that holder's own leaf lock
        backlog_now = 0
        with self._lock:
            live = [h for g in self.stage_groups for h in g.holders]
        for h in live:
            rows_q, _ = h.backlog()
            backlog_now += rows_q
        for sh in self.sink_holders:
            rows_q, _ = sh.backlog()
            backlog_now += rows_q
        reg.gauge("backlog_rows_now").set(float(backlog_now))
        # per-sink delivery counters (live view of stats.sink_batches,
        # which is only folded at _finalize): progress signal for the
        # health model's stall rule on tee-only feeds
        for sname, sh in zip(self._sink_names, self.sink_holders):
            reg.counter(mangle(f"sink_{sname}_batches")).set(sh.pulled)
        if self.storage is not None:
            reg.set_counters({"store_rows": self.storage.stored,
                              "store_dead_rows": self.storage.dead_rows,
                              "store_segments": self.storage.segment_count})
            reg.set_gauges({"store_write_s": self.storage.write_s})
            # compaction/merge level occupancy (the leveled layout)
            for lvl, n in sorted(self.storage.level_histogram().items()):
                reg.gauge(f"store_level_{lvl}_segments").set(n)
            # per-segment read telemetry feeds the PIQUE roadmap item;
            # the total makes scan traffic visible at a glance
            reads = self.storage.segment_read_counts()
            reg.counter("store_segment_reads").set(sum(reads.values()))
        if self.repair is not None:
            r = self.repair.stats
            reg.set_counters({"repair_stale_rows": r.stale_rows,
                              "repair_repaired_rows": r.repaired_rows})
        if self.compaction is not None:
            c = self.compaction.stats
            reg.set_counters({"compaction_merges": c.merges,
                              "compaction_rows_dropped": c.rows_dropped,
                              "compaction_rows_rewritten": c.rows_rewritten})
        if self.durability is not None:
            led = self.durability.ledger
            reg.set_counters(
                {"wal_backlog_records": led.backlog()
                 if hasattr(led, "backlog") else 0})

    # ------------------------------------------------------------ elasticity
    def scale_up(self, extra_partitions: int, stage: int = 0) -> int:
        """Add computing partitions to one stage group mid-feed; the
        upstream round-robin (the intake for group 0, the previous group's
        workers otherwise) picks them up on the next frame.  The new
        workers run the SAME compiled spec the group's original workers
        got — derived from the plan's stage group, never re-derived from
        the FeedConfig shim (a shim-era ``cfg.udf`` spec would enrich with
        the wrong pipeline on plan-submitted feeds).  Returns the number
        actually added (0 once the upstream has drained — a late worker
        would miss its StopRecord and never exit)."""
        group = self._group(stage)
        added = 0
        for _ in range(extra_partitions):
            with self._lock:
                if group.closing or (group.gid == 0 and
                                     self.intake is not None and
                                     self.intake.closing):
                    break
                self._add_partition_locked(group)
                self.stats.scale_ups += 1
                added += 1
        return added

    def scale_down(self, partitions: int = 1, stage: int = 0) -> int:
        """Retire computing partitions from one stage group: remove the
        holder from the upstream round-robin (under the lock, so no frame
        can target it afterwards), push a StopRecord so its worker drains
        the queued frames exactly-once into the sinks, and let the worker
        merge its ComputingStats into the feed totals as it exits.  Never
        drops below one partition (the elasticity controller additionally
        enforces its spec's ``min_partitions``).  Returns the number
        actually retired."""
        group = self._group(stage)
        dropped = 0
        for _ in range(partitions):
            with self._lock:
                if group.closing or len(group.holders) <= 1:
                    break
                holder = group.holders.pop()
                slot = next(s for s in group.slots if s.holder is holder)
                slot.retire.set()
                self.stats.scale_downs += 1
                dropped += 1
            # outside the lock: close() pushes the StopRecord (it may block
            # briefly on a full queue while the worker drains), and the
            # registry drops the holder so work stealing stops seeing it
            holder.close()
            self.manager.holder_manager.unregister(holder.holder_id)
        return dropped

    def _group(self, stage: int) -> _StageGroupRuntime:
        if not self.stage_groups:
            raise RuntimeError(
                "elasticity requires the decoupled plan path; the "
                "coupled/insert baselines are fixed-parallelism "
                "measurement rigs")
        return self.stage_groups[stage]

    def _add_partition_locked(self,  # requires-lock: _lock
                              group: _StageGroupRuntime) -> None:
        """Create holder + runner + worker for one new partition of
        ``group``.  Caller holds ``self._lock``."""
        pid = group.next_pid          # monotonic: retired ids never reused
        group.next_pid += 1
        holder = PartitionHolder((group.job, pid), self.cfg.holder_capacity)
        self.manager.holder_manager.register(holder)
        runner = ComputingRunner(group.spec, self.manager.refstore,
                                 self.manager.predeploy,
                                 device=self.manager.device)
        slot = _WorkerSlot(pid, holder, runner)
        w = threading.Thread(target=self._worker_loop, args=(group, slot),
                             name=f"{self.cfg.name}-{group.name}-{pid}",
                             daemon=True)
        slot.thread = w               # set BEFORE the slot becomes visible:
        group.holders.append(holder)  # the controller reads slots lock-free
        group.slots.append(slot)
        group.peak_partitions = max(group.peak_partitions,
                                    len(group.holders))
        self.runners.append(runner)
        group.live += 1
        self._live_workers += 1
        self.workers.append(w)
        w.start()

    # --------------------------------------------------------------- workers
    def _coalesce(self, holder: PartitionHolder, frame):
        """Merge backlogged frames (same representation only) into one
        computing batch, bounded by the row/byte budgets."""
        cfg = self.cfg
        budget = cfg.resolved_coalesce_rows
        if budget <= 0 or cfg.model == "per_record":
            return frame
        kind = dict if isinstance(frame, dict) else list
        group = [frame]
        rows = _frame_rows(frame)
        nbytes = _frame_bytes(frame)
        while rows < budget and nbytes < cfg.coalesce_bytes:
            extra = holder.pull_nowait(lambda f: isinstance(f, kind))
            if extra is None:
                break
            group.append(extra)
            rows += _frame_rows(extra)
            nbytes += _frame_bytes(extra)
        if len(group) == 1:
            return frame
        with self._lock:
            self.stats.coalesced_frames += len(group) - 1
        seqs: List[int] = []
        sids: List[int] = []
        t_old = 0.0
        for g in group:
            seqs.extend(getattr(g, "wal_seqs", None) or ())
            sids.extend(getattr(g, "span_ids", ()))
            ti = getattr(g, "t_intake", 0.0)
            if ti and (not t_old or ti < t_old):
                t_old = ti       # oldest stamp: latency covers the whole
        if sids:
            # the coalesced batch covers every merged frame's WAL records
            # AND trace spans — the stamp unions ride to the sink; the
            # span emission is what merges the journeys in the profiler
            self.obs.emit("coalesce", tuple(sids), t0=time.monotonic(),
                          rows=rows, frames=len(group))
        if kind is dict:
            # downstream stage groups carry dict batches: union the
            # stamps onto a TrackedBatch so multi-group journeys stay
            # whole end to end (the pre-feedscope code dropped them here)
            merged_b = records.concat_batches(group)
            if seqs or sids or t_old:
                return TrackedBatch(merged_b, tuple(seqs), tuple(sids),
                                    t_old)
            return merged_b
        merged: List = []
        for g in group:
            merged.extend(g)
        if seqs or sids or t_old:
            return TrackedFrame(merged, tuple(seqs), tuple(sids), t_old)
        return merged

    def _run_with_retry(self, runner: ComputingRunner, frame) -> Dict:
        attempt = 0
        while True:
            with self._lock:
                inv = self._invocation_counter
                self._invocation_counter += 1
            try:
                if self.cfg.fault_hook is not None and \
                        self.cfg.fault_hook(inv):
                    raise RuntimeError(f"injected fault @ invocation {inv}")
                return runner.run(frame)
            except Exception:
                attempt += 1
                if attempt > self.cfg.max_retries:
                    raise
                with self._lock:
                    self.stats.retries += 1
                time.sleep(self.cfg.retry_backoff_s * (2 ** (attempt - 1)))

    def _worker_loop(self, group: _StageGroupRuntime,
                     slot: _WorkerSlot) -> None:
        pid, holder, runner = slot.pid, slot.holder, slot.runner
        try:
            while True:
                frame = holder.pull(timeout=0.05)
                if frame is None or isinstance(frame, StopRecord):
                    # idle or our queue drained: try stealing a backlog —
                    # never while retiring (the point is to shed capacity)
                    stolen = None
                    if self.cfg.work_stealing and not slot.retire.is_set():
                        deep = self.manager.holder_manager.deepest(
                            group.job, exclude=pid)
                        if deep is not None and deep.depth > 1:
                            stolen = deep.steal()
                    if stolen is None:
                        if isinstance(frame, StopRecord):
                            return
                        continue
                    frame = stolen
                    with self._lock:
                        self.stats.steals += 1
                if self._sinks_dead:
                    # no live sink: computing would silently discard the
                    # output anyway — drain frames without enriching so
                    # the intake never blocks and join() can surface the
                    # sink error promptly
                    continue
                frame = self._coalesce(holder, frame)
                # durable feed: lift the WAL stamp off the raw frame BEFORE
                # the runner consumes it (parsing returns a plain dict);
                # the obs stamps (core/obs) ride the same vehicle
                wal_seqs = getattr(frame, "wal_seqs", None)
                span_ids = getattr(frame, "span_ids", ())
                t_intake = getattr(frame, "t_intake", 0.0)
                # backlog sampling happens on EVERY pull, controller or
                # not — this is what makes backlog_p95_rows report for
                # static feeds (it used to be elasticity-only)
                rows_q, _ = holder.backlog()
                self._backlog_hist.observe(float(rows_q))
                if t_intake:
                    self._backlog_age_hist.observe(
                        max(0.0, time.monotonic() - t_intake))
                t0 = time.perf_counter()
                out = self._run_with_retry(runner, frame)
                apply_dt = time.perf_counter() - t0
                holder.record_service(apply_dt)
                if span_ids:
                    self.obs.emit(f"apply.{group.name}", span_ids,
                                  t0=time.monotonic() - apply_dt,
                                  dur=apply_dt, partition=pid)
                if group.next is not None:
                    # intermediate stage group: hand the enriched batch to
                    # the next group's holders, not the sinks — re-wrapped
                    # so the obs/WAL stamps survive the hop and the next
                    # group's apply span joins the same journey
                    if wal_seqs or span_ids or t_intake:
                        out = TrackedBatch(out, wal_seqs, span_ids,
                                           t_intake)
                    self._push_downstream(group, out)
                    continue
                out = self._project(out)
                # fan-out: every sink holder gets every batch exactly once;
                # the store sink's copy is tagged with the ref-version
                # lineage the batch was enriched under (repair subsystem)
                lineage = runner.last_versions
                delivered = 0
                for si, sh in enumerate(self.sink_holders):
                    if sh.error is not None:
                        # sink consumer raised: its holder closed itself
                        # (fail-fast drain); keep feeding the healthy
                        # sinks — the error is re-raised by join()
                        continue
                    try:
                        if si == self._store_sink_idx and \
                                (lineage is not None or wal_seqs or
                                 span_ids or t_intake):
                            sh.push(_StoreBatch(out, lineage, wal_seqs,
                                                span_ids, t_intake))
                        elif span_ids or t_intake:
                            # tee sinks get the same dict payload wrapped
                            # with the obs stamps so their sink.append
                            # spans carry ids — a slow tee then shows up
                            # in the critical-path profile by name
                            sh.push(TrackedBatch(out, None, span_ids,
                                                 t_intake))
                        else:
                            sh.push(out)
                        delivered += 1
                    except RuntimeError:
                        if sh.error is None:     # not a sink failure
                            raise
                if delivered == 0 and self.sink_holders:
                    # every sink is dead: stop the adapter and switch to
                    # discard-drain (below) so the stop protocol still
                    # completes; the sink error surfaces from join()
                    self._sinks_dead = True
                    self.adapter.stop()
        except BaseException as e:
            # feedlint R1 fix: error collection races join()'s liveness
            # checks without the lock (inside _note_worker_err)
            self._note_worker_err(e)
        finally:
            self._on_worker_exit(group, slot)

    def _push_downstream(self, group: _StageGroupRuntime, out: Dict) -> None:
        """Round-robin an enriched batch into the next stage group's live
        holder list, re-targeting when the chosen holder was retired
        between snapshot and push (the same exactly-once rule the intake
        follows)."""
        nxt = group.next
        while True:
            with self._lock:
                hs = list(nxt.holders)
                i = group.rr
                group.rr += 1
            target = hs[i % len(hs)]
            try:
                target.push(out)
                return
            except RuntimeError:
                if not target.closed:
                    raise

    def _on_worker_exit(self, group: _StageGroupRuntime,
                        slot: _WorkerSlot) -> None:
        now = time.perf_counter()
        downstream: List[PartitionHolder] = []
        with self._lock:
            group.live -= 1
            self._live_workers -= 1
            self.stats.worker_seconds += now - slot.t_start
            if slot.retire.is_set():
                # scale_down fix: the retired runner's counts land in the
                # feed totals the moment its worker exits, BEFORE the
                # runner is dropped from the live lists — invocations and
                # records can never vanish from FeedStats
                self._retired_computing.merge(slot.runner.stats)
                if slot.runner in self.runners:
                    self.runners.remove(slot.runner)
                if slot in group.slots:
                    group.slots.remove(slot)
            if group.live == 0 and group.next is not None:
                # last worker of this group: drain protocol hops one group
                # downstream (§7.1 — the storage job closes after the last
                # computing job; intermediate groups close the same way)
                group.next.closing = True
                downstream = list(group.next.holders)
        for h in downstream:          # outside the lock: close() can block
            if not h.closed:
                h.close()

    def _project(self, out: Dict) -> Dict:
        """Plan-level projection: restrict the columns sinks receive (id +
        valid always flow).  Cheap dict subset — the arrays are shared, not
        copied; sinks must treat batches as read-only (they already do).
        Shared with the repair job via ``IngestPlan.restrict`` so repaired
        rows carry exactly the stored column set."""
        if self.plan is None:
            return out
        return self.plan.restrict(out)


class FeedManager:
    """The AFM: tracks active feeds, owns the predeploy cache and the
    partition-holder registry, and starts/stops the per-feed job trios."""

    def __init__(self, refstore: Optional[RefStore] = None,
                 device: DeviceLike = None):
        self.refstore = refstore or RefStore()
        # every computing runner, repair job and store query of this
        # manager's feeds runs here; None means the card (and raises
        # without one — the caller asks for the CPU explicitly)
        self.device = resolve_device(device)
        self.predeploy = PredeployCache()
        self.holder_manager = PartitionHolderManager()
        self._lock = threading.Lock()           # lock-name: manager
        self.feeds: Dict[str, FeedHandle] = {}  # guarded-by: _lock
        # feedscope live ops endpoint (core/obs/server.py), opt-in via
        # serve_obs(); started/stopped from the caller's thread only
        self._obs_server: Optional[ObsServer] = None

    # --------------------------------------------------------------- submit
    def submit(self, plan, _resume=None) -> FeedHandle:
        """Execute a declarative ingestion plan (core/plan.py).  Accepts an
        ``IngestPlan`` or an uncompiled ``Pipeline`` (compiled here against
        this manager's refstore — all validation happens before any job
        thread starts).  ``_resume`` is the private crash-restart path:
        ``FeedManager.resume`` builds a ``recovery.RecoveryState`` and
        re-submits the plan through here so both paths share the exact
        same wiring."""
        if isinstance(plan, Pipeline):
            plan = plan.compile(self.refstore)
        if not isinstance(plan, IngestPlan):
            raise TypeError("submit() takes an IngestPlan or Pipeline, "
                            f"got {type(plan).__name__}")
        cfg = FeedConfig(
            name=plan.name, udf=plan.udf, batch_size=plan.batch_size,
            num_partitions=plan.num_partitions, model=plan.model,
            refresh=plan.refresh, framework="new",
            work_stealing=plan.work_stealing, max_retries=plan.max_retries,
            retry_backoff_s=plan.retry_backoff_s,
            holder_capacity=plan.holder_capacity,
            coalesce_rows=plan.coalesce_rows,
            coalesce_bytes=plan.coalesce_bytes,
            fault_hook=plan.fault_hook, elastic=plan.elastic)
        adapter = _resume.adapter if _resume is not None else plan.adapter
        handle = FeedHandle(cfg, self, adapter, plan=plan)
        # feedlint R1 fix: check-then-insert is one critical section, so
        # two racing submits of the same name cannot both win
        with self._lock:
            if plan.name in self.feeds:
                raise KeyError(f"feed {plan.name} already active")
            self.feeds[plan.name] = handle
        handle._t0 = time.perf_counter()
        self._start_new(cfg, handle, plan, resume=_resume)
        return handle

    def resume(self, plan, durable_dir: Optional[str] = None) -> FeedHandle:
        """Crash-restart a durable feed (core/recovery.py): recover every
        storage partition from its manifest, load the last checkpoint,
        replay the intake log's tail through the normal pipeline (the
        idempotent pk-index insert de-duplicates rows the crashed run
        already stored), fast-forward the adapter to the last durable
        offset, and hand back a live FeedHandle.  ``durable_dir``
        overrides the plan's ``DurableSpec.dir`` (resume a directory the
        plan object didn't originally point at)."""
        from repro_torch.core import recovery
        return recovery.resume_feed(self, plan, durable_dir)

    # ------------------------------------------------- baseline entry point
    def start(self, cfg: FeedConfig, adapter: Adapter) -> FeedHandle:
        """Entry point for the paper-baseline measurement rigs ONLY
        (framework "current"/"balanced"/"insert" — fixed cfg-driven
        pipelines the figures compare against).  The deprecated
        framework="new" lowering is gone: decoupled feeds are built with
        ``pipeline(adapter).parse(...)....store()/.tee(...)`` and
        ``submit`` (FeedConfig survives as the internal runtime config a
        compiled plan lowers onto)."""
        if cfg.framework == "new":
            raise ValueError(
                "FeedManager.start no longer lowers framework='new' "
                "FeedConfigs (the deprecated shim was removed): build the "
                "feed with pipeline(adapter).parse(...)....store()/"
                ".tee(...) and FeedManager.submit instead")

        handle = FeedHandle(cfg, self, adapter)
        with self._lock:
            if cfg.name in self.feeds:
                raise KeyError(f"feed {cfg.name} already active")
            self.feeds[cfg.name] = handle
        handle._t0 = time.perf_counter()
        nstore = cfg.storage_partitions or cfg.num_partitions
        handle.storage = StorageJob(nstore, cfg.spill_dir, cfg.upsert,
                                    device=self.device)

        if cfg.framework in ("current", "balanced"):
            self._start_coupled(cfg, handle,
                                balanced=cfg.framework == "balanced")
        elif cfg.framework == "insert":
            self._start_insert(cfg, handle)
        else:
            raise ValueError(cfg.framework)
        return handle

    def _start_new(self, cfg: FeedConfig, handle: FeedHandle,
                   plan: IngestPlan, resume=None) -> None:
        # durable plans: attach the WAL + ledger runtime — fresh feeds
        # create/refuse-dirty the log directory, crash-restarts arrive
        # with the already-recovered runtime in the RecoveryState
        dspec = (plan.store_spec.durable
                 if plan.store_spec is not None else None)
        if plan.trace is not None:
            # span tracing is plan-opt-in; metrics are always on
            handle.obs.enable_trace(plan.trace)
        if plan.profile is not None:
            # the profiler consumes spans, so profile=... implies a
            # default tracer when the plan didn't configure one itself
            if handle.obs.tracer is None:
                handle.obs.enable_trace(TraceSpec())
            handle.profiler = JourneyProfiler(plan.profile)
        if resume is not None:
            handle.durability = resume.runtime
        elif dspec is not None:
            handle.durability = DurabilityRuntime.create(dspec)
        ledger = (handle.durability.ledger
                  if handle.durability is not None else None)
        # one active holder per sink: the plan's multi-sink fan-out
        for i, spec in enumerate(plan.sinks):
            if spec.is_store:
                nstore = spec.store.partitions or cfg.num_partitions
                handle.storage = StorageJob(nstore, spec.store.spill_dir,
                                            spec.store.upsert,
                                            spec.store.segment_rows,
                                            spec.store.zone_map_cols,
                                            spec.store.sort_key,
                                            obs=handle.obs,
                                            device=self.device)
                handle._store_sink_idx = i
                consumer = _store_consumer(handle.storage, ledger,
                                           obs=handle.obs)
            else:
                consumer = spec.consumer
            sh = ActivePartitionHolder(
                (f"{cfg.name}:storage", i), consumer,
                capacity=cfg.holder_capacity, obs=handle.obs)
            self.holder_manager.register(sh)
            handle.sink_holders.append(sh)
            handle._sink_names.append(spec.name)
        handle.storage_holder = handle.sink_holders[0]
        if resume is not None and handle.storage is not None:
            # crash-restart: rebuild every partition from its manifest
            # BEFORE any worker can write — the recovered pk index is
            # what de-duplicates the replayed WAL tail
            handle.storage.recover()
            if resume.reset_lineage:
                # checkpointed ref fingerprints did not match the current
                # reference tables: drop lineage so repair re-scans
                # EVERYTHING rather than trusting stale versions
                handle.storage.reset_lineage()

        # stage groups: the plan's independently-scalable chain segments
        # (pre-stage-group IngestPlans lower to one group over plan.udf)
        groups = plan.stage_groups or (StageGroup(
            plan.udf.name if plan.udf is not None else "parse",
            plan.udf, 0, plan.elastic),)
        prev: Optional[_StageGroupRuntime] = None
        for gid, g in enumerate(groups):
            job = (f"{cfg.name}:intake" if gid == 0
                   else f"{cfg.name}:stage{gid}")
            rt = _StageGroupRuntime(
                gid, g.name, job,
                ComputingSpec(g.udf, cfg.batch_size, cfg.model,
                              cfg.refresh), g.elastic)
            handle.stage_groups.append(rt)
            if prev is not None:
                prev.next = rt
            prev = rt
        # the intake's live round-robin list IS group 0's holder list
        handle.holders = handle.stage_groups[0].holders
        for g, rt in zip(groups, handle.stage_groups):
            n = g.partitions or cfg.num_partitions
            if resume is not None:
                # resume at the learned scale: the checkpoint persisted
                # per-group partition counts (ElasticityController state)
                n = resume.partitions.get(rt.name, n)
            if rt.elastic is not None:
                # elastic groups start inside their declared bounds
                n = min(max(n, rt.elastic.min_partitions),
                        rt.elastic.max_partitions)
            else:
                n = max(1, n)
            with handle._lock:
                for _ in range(n):
                    handle._add_partition_locked(rt)
        wal = (handle.durability.wal
               if handle.durability is not None else None)
        if wal is not None:
            wal.set_fsync_histogram(
                handle.obs.registry.histogram("wal_fsync_s"))
        handle.intake = IntakeJob(handle.adapter, handle.holders,
                                  lock=handle._lock, wal=wal,
                                  ledger=ledger, obs=handle.obs)
        handle.intake.start()
        if any(rt.elastic is not None for rt in handle.stage_groups):
            handle.controller = ElasticityController(
                handle, cfg.batch_size, name=cfg.name)
            handle.controller.start()
        store_spec = plan.store_spec
        if store_spec is not None and store_spec.refresh is not None:
            # progressive re-enrichment: the background repair scheduler
            # (compile() guaranteed an enrich stage and a single group)
            handle.repair = RepairJob(plan, handle.storage, self.refstore,
                                      self.predeploy, handle=handle,
                                      device=self.device)
            if resume is not None and resume.repair_events:
                # checkpointed ref-event log (fingerprints matched):
                # restore BEFORE start so the first scheduler pass sees it
                handle.repair.restore_events(resume.repair_events)
            handle.repair.start()
        if store_spec is not None and store_spec.compact is not None:
            # background space reclaim: budgeted, yields to ingestion the
            # same way repair does (core/compaction.py)
            handle.compaction = CompactionJob(
                handle.storage, store_spec.compact, cfg.batch_size,
                handle=handle, name=cfg.name)
            handle.compaction.start()
        if handle.durability is not None:
            # coordinated checkpoints: start LAST so every job the
            # checkpoint snapshots (storage, repair, stage groups) exists
            ref_tables = (plan.udf.ref_tables
                          if handle.repair is not None and
                          plan.udf is not None else ())
            handle.durability.start(handle, self.refstore, ref_tables)

    # ------------------------------------------------- coupled baselines
    def _start_coupled(self, cfg: FeedConfig, handle: FeedHandle,
                       balanced: bool) -> None:
        """'Current feeds': one chained job — parse -> UDF (Model 3, state
        never refreshed) -> store.  'Balanced': parsing (and the chained
        work) divided over num_partitions threads."""
        nthreads = cfg.num_partitions if balanced else 1
        spec = ComputingSpec(cfg.udf, cfg.batch_size, model="stream")
        handle.holders = [PartitionHolder((f"{cfg.name}:intake", i),
                                          cfg.holder_capacity)
                          for i in range(nthreads)]
        for h in handle.holders:
            self.holder_manager.register(h)

        def loop(pid: int, holder: PartitionHolder,
                 runner: ComputingRunner):
            try:
                while True:
                    frame = holder.pull(timeout=0.05)
                    if isinstance(frame, StopRecord):
                        return
                    if frame is None:
                        continue
                    out = runner.run(frame)       # parse+enrich chained
                    handle.storage.write(out)     # ... with storage
            except BaseException as e:
                handle._note_worker_err(e)

        for i, h in enumerate(handle.holders):
            runner = ComputingRunner(spec, self.refstore, self.predeploy,
                                     device=self.device)
            handle.runners.append(runner)
            w = threading.Thread(target=loop, args=(i, h, runner),
                                 name=f"{cfg.name}-coupled-{i}", daemon=True)
            handle.workers.append(w)
            w.start()
        handle.intake = IntakeJob(handle.adapter, handle.holders)
        handle.intake.start()

    def _start_insert(self, cfg: FeedConfig, handle: FeedHandle) -> None:
        """Approach 1 (§5.2.1): an external program issuing repeated INSERT
        statements — every statement re-pays query compilation and job
        distribution, i.e. NO predeploy cache: a fresh one per batch."""
        spec = ComputingSpec(cfg.udf, cfg.batch_size, model="per_batch")

        def loop():
            try:
                runner = ComputingRunner(spec, self.refstore,
                                         PredeployCache(),
                                         device=self.device)
                handle.runners.append(runner)
                for frame in handle.adapter.frames():
                    runner.cache = PredeployCache()   # recompilation cost
                    out = runner.run(frame)
                    handle.storage.write(out)
                    # _frame_rows, not len(): a dict frame's len() is its
                    # COLUMN count; take the handle lock — stats are also
                    # read/merged from the joining thread
                    with handle._lock:
                        handle.stats.frames_in += 1
                        handle.stats.records_in += _frame_rows(frame)
            except BaseException as e:
                handle._note_worker_err(e)

        w = threading.Thread(target=loop, name=f"{cfg.name}-insert",
                             daemon=True)
        handle.workers.append(w)
        w.start()

    # ----------------------------------------------------------- feedscope
    def active_feeds(self) -> Dict[str, FeedHandle]:
        """Snapshot of the active feed table (name -> handle).  The live
        ops endpoint renders from this copy, so no HTTP handler ever
        holds the manager lock while reading feed state."""
        with self._lock:
            return dict(self.feeds)

    def serve_obs(self, port: int = 0,
                  host: str = "127.0.0.1") -> ObsServer:
        """Start (idempotently) the zero-dependency live ops endpoint:
        ``/metrics`` (Prometheus text across all active feeds),
        ``/health`` (SLO verdicts; 503 when any feed stalls),
        ``/profile`` (critical-path attribution JSON) and ``/trace``
        (recent raw spans).  ``port=0`` binds a free port — read the
        result's ``.url``.  The server is a daemon thread reading only
        snapshots; stop it with ``stop_obs()``."""
        if self._obs_server is None:
            self._obs_server = ObsServer(self, host, port).start()
        return self._obs_server

    def stop_obs(self) -> None:
        """Shut the live ops endpoint down (no-op when never started)."""
        srv = self._obs_server
        if srv is not None:
            self._obs_server = None
            srv.stop()

    def stop_all(self) -> None:
        with self._lock:
            handles = list(self.feeds.values())
        for h in handles:
            h.stop()
