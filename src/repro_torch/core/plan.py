"""Declarative ingestion plans: the ``Pipeline`` builder and the immutable
``IngestPlan`` it compiles into.

The paper frames ingestion-time enrichment *declaratively* — a feed is a
query plan (adapter -> parse -> UDFs -> dataset), compiled once and invoked
per batch.  This module is that abstraction for this repo:

    plan = (pipeline(adapter, "tweets")
            .parse(batch_size=420)
            .enrich(Q.Q1)
            .enrich(Q.Q2)
            .filter(lambda b: b["safety_level"] >= 0, name="joined_only")
            .project("safety_level", "religious_population")
            .tee(lm_data_plane_sink)
            .store(spill_dir="/data/enriched"))
    handle = manager.submit(plan)

``compile()`` performs the whole-plan optimizations and validations that a
per-batch runtime cannot:

  * **Stage fusion** — consecutive ``enrich``/``filter`` stages fuse into
    ONE ``EnrichUDF`` (``queries.chain``): a single predeployed apply (one
    invocation per batch) over the union of the stages' ref
    tables, with per-stage ``state_fn``s so Model-2/3 state semantics are
    preserved *per stage* (see ``ComputingRunner._get_staged_state``).
  * **Up-front validation** — every referenced table must exist in the
    ``RefStore``, and each stage runs on ``meta``-device tensors (shapes
    and dtypes only, no data) built from the tweet schema + actual
    reference dtypes, so dtype/shape
    errors and unknown columns raise ``PlanError`` at compile time, not
    mid-feed in a worker thread.
  * **Multi-sink lowering** — each ``tee``/``store`` sink becomes one
    ``ActivePartitionHolder`` on the feed's fan-out, so every enriched
    batch is delivered to every sink exactly once, each sink consuming
    from its own bounded queue (independent backpressure).

``FeedConfig`` + ``FeedManager.start`` remain as a thin compatibility shim
that builds a one-stage plan (see feed.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import numpy as np

from repro_torch.core import records
from repro_torch.core.compaction import CompactionSpec
from repro_torch.core.durability import DurableSpec
from repro_torch.core.elasticity import ElasticSpec
from repro_torch.core.enrich.queries import EnrichUDF, chain, make_filter
from repro_torch.core.intake import Adapter
from repro_torch.core.obs import HealthSpec, ProfileSpec, TraceSpec
from repro_torch.core.refdata import RefStore
from repro_torch.core.repair import RepairSpec


class PlanError(ValueError):
    """Invalid ingestion plan, detected at compile time."""


@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """The storage-job sink (partitioned column store, see storage.py).
    ``refresh`` attaches a progressive re-enrichment policy: a background
    ``RepairJob`` (core/repair.py) keeps the stored rows' enrichments
    current as reference tables are upserted mid- and post-ingestion.

    Read-side layout (core/query.py consumes these — INGESTBASE-style
    ingestion-time decisions the analytical scan path exploits):
    ``zone_map_cols`` picks the columns whose per-segment min/max is
    persisted at flush for predicate pruning (None = every eligible 1-D
    numeric column; () disables); ``sort_key`` clusters each flushed
    segment by that column.  ``compact`` attaches a budgeted background
    ``CompactionJob`` (core/compaction.py) reclaiming superseded/deleted
    row versions as upserts and repair churn the store.

    ``durable=DurableSpec(...)`` makes the whole FEED crash-restartable
    (core/durability.py): a write-ahead intake log, coordinated
    checkpoints, and ``FeedManager.resume`` replay with storage-side
    dedup — exactly-once ingestion across a kill.  Requires a resumable
    adapter (compile-checked); ``spill_dir`` defaults to a ``store/``
    subdirectory of the durable dir when unset."""
    partitions: int = 0            # 0 -> plan.num_partitions
    spill_dir: Optional[str] = None
    upsert: bool = False
    segment_rows: int = 100_000
    refresh: Optional[RepairSpec] = None
    zone_map_cols: Optional[Tuple[str, ...]] = None
    sort_key: Optional[str] = None
    compact: Optional[CompactionSpec] = None
    durable: Optional[DurableSpec] = None


@dataclasses.dataclass(frozen=True)
class SinkSpec:
    name: str
    consumer: Optional[Callable[[Dict], None]] = None   # tee sink
    store: Optional[StoreSpec] = None                   # storage sink

    @property
    def is_store(self) -> bool:
        return self.store is not None


@dataclasses.dataclass(frozen=True)
class StageGroup:
    """One independently-scalable segment of the compiled chain: its own
    fused UDF, its own worker pool + holders at runtime, its own elastic
    bounds.  Groups are linked by intermediate ``PartitionHolder``s, so a
    heavy-state stage (Q6) scales — and later, places — independently of
    cheap probe stages."""
    name: str
    udf: Optional[EnrichUDF]       # fused sub-chain of this group (or None)
    partitions: int = 0            # 0 -> plan.num_partitions
    elastic: Optional[ElasticSpec] = None


# FeedConfig knobs a plan carries through to the feed runtime
_OPTION_KEYS = ("num_partitions", "holder_capacity", "work_stealing",
                "max_retries", "retry_backoff_s", "coalesce_rows",
                "coalesce_bytes", "fault_hook", "elastic", "trace",
                "profile", "health")


def _coerce_elastic(value) -> Optional[ElasticSpec]:
    if value is None or isinstance(value, ElasticSpec):
        return value
    if isinstance(value, dict):
        try:
            return ElasticSpec(**value)
        except (TypeError, ValueError) as e:
            raise PlanError(f"invalid elastic spec {value!r}: {e}") from e
    raise PlanError("elastic must be an ElasticSpec or dict, got "
                    f"{type(value).__name__}")


def _coerce_trace(value) -> Optional[TraceSpec]:
    if value is None or isinstance(value, TraceSpec):
        return value
    if value is True:
        return TraceSpec()
    if value is False:
        return None
    if isinstance(value, dict):
        try:
            return TraceSpec(**value)
        except (TypeError, ValueError) as e:
            raise PlanError(f"invalid trace spec {value!r}: {e}") from e
    raise PlanError("trace must be a TraceSpec, dict, or bool, got "
                    f"{type(value).__name__}")


def _coerce_profile(value) -> Optional[ProfileSpec]:
    if value is None or isinstance(value, ProfileSpec):
        return value
    if value is True:
        return ProfileSpec()
    if value is False:
        return None
    if isinstance(value, dict):
        try:
            return ProfileSpec(**value)
        except (TypeError, ValueError) as e:
            raise PlanError(f"invalid profile spec {value!r}: {e}") from e
    raise PlanError("profile must be a ProfileSpec, dict, or bool, got "
                    f"{type(value).__name__}")


def _coerce_health(value) -> Optional[HealthSpec]:
    if value is None or isinstance(value, HealthSpec):
        return value
    if value is True:
        return HealthSpec()
    if value is False:
        return None
    if isinstance(value, dict):
        try:
            return HealthSpec(**value)
        except (TypeError, ValueError) as e:
            raise PlanError(f"invalid health spec {value!r}: {e}") from e
    raise PlanError("health must be a HealthSpec, dict, or bool, got "
                    f"{type(value).__name__}")


def _coerce_repair(value) -> Optional[RepairSpec]:
    if value is None or isinstance(value, RepairSpec):
        return value
    if isinstance(value, dict):
        try:
            return RepairSpec(**value)
        except (TypeError, ValueError) as e:
            raise PlanError(f"invalid refresh spec {value!r}: {e}") from e
    raise PlanError("store(refresh=...) takes a RepairSpec or dict, got "
                    f"{type(value).__name__}")


def _coerce_compact(value) -> Optional[CompactionSpec]:
    if value is None or isinstance(value, CompactionSpec):
        return value
    if isinstance(value, dict):
        try:
            return CompactionSpec(**value)
        except (TypeError, ValueError) as e:
            raise PlanError(f"invalid compact spec {value!r}: {e}") from e
    raise PlanError("store(compact=...) takes a CompactionSpec or dict, "
                    f"got {type(value).__name__}")


def _coerce_durable(value) -> Optional[DurableSpec]:
    if value is None or isinstance(value, DurableSpec):
        return value
    if isinstance(value, dict):
        try:
            return DurableSpec(**value)
        except (TypeError, ValueError) as e:
            raise PlanError(f"invalid durable spec {value!r}: {e}") from e
    raise PlanError("store(durable=...) takes a DurableSpec or dict, "
                    f"got {type(value).__name__}")


@dataclasses.dataclass(frozen=True)
class IngestPlan:
    """A compiled, immutable ingestion plan.  ``FeedManager.submit``
    executes it; everything here is validated and fused already."""
    name: str
    adapter: Adapter
    udf: Optional[EnrichUDF]             # fused enrich+filter chain (or None)
    stage_names: Tuple[str, ...]         # fused stages, in order
    sinks: Tuple[SinkSpec, ...]          # >= 1; at most one store
    output_columns: Tuple[str, ...]      # columns sinks receive (validated)
    project_cols: Optional[Tuple[str, ...]] = None
    batch_size: int = 420
    model: str = "per_batch"
    refresh: str = "always"
    num_partitions: int = 1
    holder_capacity: int = 8
    work_stealing: bool = True
    max_retries: int = 3
    retry_backoff_s: float = 0.05
    coalesce_rows: Optional[int] = None  # None -> feed.py's auto default
    coalesce_bytes: int = 8 << 20
    fault_hook: Optional[Callable[[int], bool]] = None
    # per-stage parallelism: >= 1 independently-scalable segments of the
    # fused chain (always at least one group; single-group plans execute
    # exactly as before).  Plan-level ``elastic`` is the default bound set
    # for groups that do not declare their own.
    stage_groups: Tuple[StageGroup, ...] = ()
    elastic: Optional[ElasticSpec] = None
    # batch-span tracing policy (core/obs): metrics are always on, but
    # per-hop span emission is opt-in via ``.options(trace=...)``
    trace: Optional[TraceSpec] = None
    # feedscope (core/obs): journey profiler policy — implies a default
    # tracer when ``trace`` is unset — and SLO thresholds for the feed
    # health model (``FeedHandle.profile()`` / ``health()``, /profile
    # and /health on the live ops endpoint)
    profile: Optional[ProfileSpec] = None
    health: Optional[HealthSpec] = None

    @property
    def store_spec(self) -> Optional[StoreSpec]:
        for s in self.sinks:
            if s.is_store:
                return s.store
        return None

    def restrict(self, out: Dict) -> Dict:
        """Apply the plan's projection to an enriched batch (id + valid
        always flow).  Shared by the feed's sink fan-out and the repair
        job, so repaired rows carry exactly the stored column set."""
        if self.project_cols is None:
            return out
        return {k: out[k] for k in self.project_cols if k in out}


def pipeline(adapter: Adapter, name: str = "pipeline") -> "Pipeline":
    """Entry point of the declarative API: a builder over ``adapter``."""
    return Pipeline(adapter, name)


class Pipeline:
    """Ordered stage recorder.  Builder calls only record; all validation
    (ordering, ref tables, dtypes) happens in ``compile`` so a bad plan
    fails in one place, before any job starts."""

    def __init__(self, adapter: Adapter, name: str = "pipeline"):
        self._adapter = adapter
        self._name = name
        self._parse: Dict[str, Any] = dict(batch_size=420,
                                           model="per_batch",
                                           refresh="always")
        self._opts: Dict[str, Any] = {}
        # ordered log of ("enrich"|"filter"|"project"|"tee"|"store", payload)
        self._stages: list = []
        self._n_filters = 0

    # ------------------------------------------------------------- builders
    def parse(self, batch_size: int = 420, model: str = "per_batch",
              refresh: str = "always") -> "Pipeline":
        self._parse = dict(batch_size=batch_size, model=model,
                           refresh=refresh)
        return self

    def options(self, **kw: Any) -> "Pipeline":
        """Feed-runtime knobs: num_partitions, holder_capacity,
        work_stealing, max_retries, retry_backoff_s, coalesce_rows,
        coalesce_bytes, fault_hook, elastic (an ``ElasticSpec`` or kwargs
        dict — the feed-wide default elastic bounds; per-stage bounds go on
        ``enrich(..., elastic=...)``), trace (a ``TraceSpec``, kwargs dict,
        or True — enables per-hop batch span tracing, see core/obs),
        profile (a ``ProfileSpec``, kwargs dict, or True — journey
        reconstruction + critical-path bottleneck attribution via
        ``handle.profile()``; implies a default tracer), health (a
        ``HealthSpec``, kwargs dict, or True — SLO thresholds for
        ``handle.health()``; defaults apply even without the option)."""
        for k in kw:
            if k not in _OPTION_KEYS:
                raise PlanError(f"unknown option {k!r} "
                                f"(valid: {', '.join(_OPTION_KEYS)})")
        if "elastic" in kw:
            kw = dict(kw, elastic=_coerce_elastic(kw["elastic"]))
        if "trace" in kw:
            kw = dict(kw, trace=_coerce_trace(kw["trace"]))
        if "profile" in kw:
            kw = dict(kw, profile=_coerce_profile(kw["profile"]))
        if "health" in kw:
            kw = dict(kw, health=_coerce_health(kw["health"]))
        self._opts.update(kw)
        return self

    def enrich(self, udf: EnrichUDF, partitions: Optional[int] = None,
               elastic: Optional[ElasticSpec] = None) -> "Pipeline":
        """Add an enrichment stage.  Declaring ``partitions`` and/or
        ``elastic`` makes this stage a **stage-group boundary**: it gets its
        own holder + worker pool (following undeclared stages fuse into it),
        so a heavy stage scales independently of the rest of the chain."""
        if partitions is not None and partitions < 1:
            raise PlanError(
                f"enrich(partitions=...) must be >= 1, got {partitions}")
        self._stages.append(("enrich", (udf, partitions,
                                        _coerce_elastic(elastic))))
        return self

    def filter(self, pred: Callable, name: Optional[str] = None
               ) -> "Pipeline":
        self._n_filters += 1
        fname = name or f"filter_{self._n_filters}"
        self._stages.append(("filter", (make_filter(fname, pred),
                                        None, None)))
        return self

    def project(self, *cols: str) -> "Pipeline":
        self._stages.append(("project", tuple(cols)))
        return self

    def tee(self, sink: Callable[[Dict], None],
            name: Optional[str] = None) -> "Pipeline":
        self._stages.append(("tee", (name, sink)))
        return self

    def store(self, partitions: int = 0, spill_dir: Optional[str] = None,
              upsert: bool = False, segment_rows: int = 100_000,
              refresh=None, zone_map_cols: Optional[Tuple[str, ...]] = None,
              sort_key: Optional[str] = None, compact=None,
              durable=None) -> "Pipeline":
        """The column-store sink; at runtime ``FeedHandle.query()`` (or
        ``handle.storage.query()``) opens the analytical query subsystem
        over it (core/query.py).  ``refresh=RepairSpec(...)`` (or a kwargs
        dict) enables progressive re-enrichment: a background repair job
        re-runs the plan's enrich stages over stored rows whose ref-version
        lineage went stale (see core/repair.py).  ``zone_map_cols``/
        ``sort_key`` are the read-side layout knobs and ``compact=
        CompactionSpec(...)`` the background space-reclaim policy — see
        ``StoreSpec``.  ``durable=DurableSpec(...)`` (or a kwargs dict)
        makes the feed crash-restartable via a write-ahead intake log +
        checkpoints (core/durability.py; resume with
        ``FeedManager.resume``)."""
        dspec = _coerce_durable(durable)
        if dspec is not None and spill_dir is None:
            # a durable feed without a durable store is pointless — the
            # replay dedup needs the recovered pk index
            spill_dir = dspec.store_dir
        self._stages.append(("store", StoreSpec(
            partitions, spill_dir, upsert, segment_rows,
            _coerce_repair(refresh),
            tuple(zone_map_cols) if zone_map_cols is not None else None,
            sort_key, _coerce_compact(compact), dspec)))
        return self

    # -------------------------------------------------------------- compile
    def compile(self, refstore: RefStore) -> IngestPlan:
        """Validate + fuse + lower into an immutable ``IngestPlan``."""
        udfs, project_cols, sinks = self._split_stages()
        fused = self._fuse([u for u, _, _ in udfs])
        self._check_ref_tables(fused, refstore)
        out_cols = _validate_dtypes(fused, refstore,
                                    self._parse["batch_size"],
                                    self._parse["model"])
        if project_cols is not None:
            unknown = [c for c in project_cols if c not in out_cols]
            if unknown:
                raise PlanError(
                    f"project() references unknown column(s) {unknown}; "
                    f"available: {sorted(out_cols)}")
            # id + valid always flow: storage partitioning and validity
            # masking depend on them
            project_cols = tuple(dict.fromkeys(
                ("id", "valid") + tuple(project_cols)))
            delivered = project_cols
        else:
            delivered = tuple(out_cols)
        groups = self._group_stages(udfs, fused)
        for g in groups:
            if g.elastic is not None and g.partitions and not (
                    g.elastic.min_partitions <= g.partitions
                    <= g.elastic.max_partitions):
                raise PlanError(
                    f"stage group {g.name!r}: partitions={g.partitions} "
                    "outside elastic bounds "
                    f"[{g.elastic.min_partitions}, "
                    f"{g.elastic.max_partitions}]")
        self._check_repair(fused, sinks, project_cols, groups)
        self._check_store(sinks, delivered)
        self._check_durable(sinks, groups)
        return IngestPlan(
            name=self._name, adapter=self._adapter, udf=fused,
            stage_names=tuple(u.name for u in (
                fused.stages or (fused,))) if fused is not None else (),
            sinks=sinks, output_columns=delivered,
            project_cols=project_cols, stage_groups=groups,
            **self._parse, **self._opts)

    def _group_stages(self, udfs, fused) -> Tuple[StageGroup, ...]:
        """Split the chain at declared stage boundaries.  A stage with
        ``partitions``/``elastic`` opens a new group; undeclared stages fuse
        into the current one (a filter right after Q6 runs at Q6's
        parallelism).  Undeclared groups inherit the plan-level elastic
        default from ``options(elastic=...)``."""
        default_elastic = self._opts.get("elastic")
        if not udfs:
            return (StageGroup("parse", None, 0, default_elastic),)
        runs: list = []
        for udf, partitions, elastic in udfs:
            boundary = partitions is not None or elastic is not None
            if boundary or not runs:
                runs.append([partitions or 0, elastic, [udf]])
            else:
                runs[-1][2].append(udf)
        if len(runs) == 1:
            # single group: keep the WHOLE-chain fusion object so the
            # predeploy cache identity matches plan.udf (warmed elsewhere)
            p, el, _ = runs[0]
            return (StageGroup(fused.name, fused, p,
                               el or default_elastic),)
        groups = []
        for p, el, members in runs:
            gudf = (members[0] if len(members) == 1 else
                    chain(">".join(u.name for u in members), *members))
            groups.append(StageGroup(gudf.name, gudf, p,
                                     el or default_elastic))
        return tuple(groups)

    def _check_repair(self, fused, sinks, project_cols, groups) -> None:
        """Progressive re-enrichment preconditions, enforced at compile
        time so a repair-enabled plan can never reach a state it cannot
        repair from."""
        spec = next((s.store.refresh for s in sinks if s.is_store), None)
        if spec is None:
            return
        if fused is None:
            raise PlanError(
                "store(refresh=RepairSpec(...)) needs at least one "
                "enrich stage: there is nothing to re-enrich")
        if self._parse["model"] == "per_record":
            raise PlanError(
                "store(refresh=...) is incompatible with model="
                "'per_record': repair re-enriches at batch granularity "
                "through the per-batch predeployed executable")
        if self._parse["model"] == "stream":
            raise PlanError(
                "store(refresh=...) is incompatible with model='stream': "
                "stream feeds enrich every batch with feed-lifetime state "
                "built under the INITIAL ref versions, while lineage "
                "records the per-batch snapshot versions — rows enriched "
                "from stale state would be tagged fresh and never "
                "repaired (use model='per_batch' with refresh='version' "
                "for stream-like cost with repairable lineage)")
        if len(groups) > 1:
            raise PlanError(
                "store(refresh=...) requires a single stage group: with "
                "per-stage splits the storage-bound batch only carries "
                "the LAST group's ref-version lineage, so staleness of "
                "earlier groups' tables could be missed (fuse the chain, "
                "or use feed-wide options(elastic=...) which keeps one "
                "group)")
        if project_cols is not None:
            missing = [c for c in records.TWEET_SCHEMA
                       if c not in project_cols]
            if missing:
                raise PlanError(
                    "store(refresh=...) needs every input schema column "
                    "stored so rows can be re-enriched from scratch; "
                    f"project() drops {missing}")

    def _check_store(self, sinks, delivered) -> None:
        """Read-side layout knobs must name columns the store will actually
        receive — caught here, not as silently-absent zone maps or an
        unsorted 'sorted' store mid-feed."""
        spec = next((s.store for s in sinks if s.is_store), None)
        if spec is None:
            return
        unknown = [c for c in (spec.zone_map_cols or ())
                   if c not in delivered]
        if unknown:
            raise PlanError(
                f"store(zone_map_cols=...) references column(s) {unknown} "
                f"the store never receives; available: {sorted(delivered)}")
        if spec.sort_key is not None and spec.sort_key not in delivered:
            raise PlanError(
                f"store(sort_key={spec.sort_key!r}) is not a stored "
                f"column; available: {sorted(delivered)}")
        if spec.compact is not None and \
                spec.compact.level_target_rows > 0 and not spec.spill_dir:
            raise PlanError(
                "compact=CompactionSpec(level_target_rows=...) enables "
                "leveled segment merging, which only applies to FLUSHED "
                "segments — set store(spill_dir=...) (or durable=..., "
                "which implies one), or drop level_target_rows")

    def _check_durable(self, sinks, groups) -> None:
        """Durable-feed preconditions, rejected at compile time — not as
        a restart-time surprise when the crashed data is already gone."""
        spec = next((s.store.durable for s in sinks if s.is_store), None)
        if spec is None:
            return
        ad = self._adapter
        if not getattr(ad, "resumable", False):
            raise PlanError(
                f"store(durable=...) requires a resumable adapter, but "
                f"{type(ad).__name__} declares resumable=False — input "
                "lost in a crash could never be replayed (SocketAdapter: "
                "spool the stream to a file and use FileAdapter)")
        if len(groups) > 1:
            raise PlanError(
                "store(durable=...) requires a single stage group: the "
                "WAL sequence stamp rides the batch to the store sink, "
                "and per-stage splits drop it at the intermediate "
                "holder hand-off (fuse the chain, or use feed-wide "
                "options(elastic=...) which keeps one group)")
        if self._parse["model"] == "per_record":
            raise PlanError(
                "store(durable=...) is incompatible with model="
                "'per_record': the per-record path re-frames batches, "
                "losing the WAL sequence stamp the checkpoint watermark "
                "is driven by")

    # -------------------------------------------------------------- helpers
    def _split_stages(self):
        udfs: list = []
        project_cols: Optional[Tuple[str, ...]] = None
        sinks: list = []
        seen_sink = False
        store_seen = False
        tee_auto = 0
        for kind, payload in self._stages:
            if kind in ("enrich", "filter", "project") and seen_sink:
                raise PlanError(
                    f"{kind}() after a sink stage (tee/store): transform "
                    "stages must precede all sinks")
            if kind == "enrich":
                udf, _, _ = payload
                if not isinstance(udf, EnrichUDF):
                    raise PlanError(
                        "enrich() takes an EnrichUDF, got "
                        f"{type(udf).__name__}")
                udfs.append(payload)
            elif kind == "filter":
                udfs.append(payload)
            elif kind == "project":
                if project_cols is not None:
                    raise PlanError("project() may appear at most once")
                if not payload:
                    raise PlanError("project() needs at least one column")
                project_cols = payload
            elif kind == "tee":
                seen_sink = True
                name, sink = payload
                tee_auto += 1
                sinks.append(SinkSpec(name or f"tee_{tee_auto}",
                                      consumer=sink))
            elif kind == "store":
                seen_sink = True
                if store_seen:
                    raise PlanError("store() may appear at most once")
                store_seen = True
                sinks.append(SinkSpec("store", store=payload))
        if not sinks:
            raise PlanError(
                "plan has no sink: end with .store(...) and/or .tee(sink)")
        if self._parse["model"] not in ("per_record", "per_batch", "stream"):
            raise PlanError(f"unknown model {self._parse['model']!r}")
        if self._parse["refresh"] not in ("always", "version"):
            raise PlanError(f"unknown refresh {self._parse['refresh']!r}")
        return udfs, project_cols, tuple(sinks)

    def _fuse(self, udfs) -> Optional[EnrichUDF]:
        if not udfs:
            return None
        if len(udfs) == 1:
            return udfs[0]   # keep the original predeploy cache identity
        return chain(">".join(u.name for u in udfs), *udfs)

    def _check_ref_tables(self, fused: Optional[EnrichUDF],
                          refstore: RefStore) -> None:
        if fused is None:
            return
        for stage in (fused.stages or (fused,)):
            missing = [t for t in stage.ref_tables if t not in refstore]
            if missing:
                raise PlanError(
                    f"stage {stage.name!r} references missing reference "
                    f"table(s) {missing}: create/populate them in the "
                    "RefStore before compiling the plan")


def _meta(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype-only tensor: ops on it compute nothing."""
    tdt = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
    return torch.empty(tuple(shape), dtype=tdt, device="meta")


def _batch_struct(batch_size: int) -> Dict[str, torch.Tensor]:
    out = {}
    for k, dt in records.TWEET_SCHEMA.items():
        if dt.subdtype is not None:
            base, shape = dt.subdtype
            out[k] = _meta((batch_size,) + shape, base)
        else:
            out[k] = _meta((batch_size,), dt)
    out["valid"] = _meta((batch_size,), np.dtype(bool))
    return out


def _validate_dtypes(fused: Optional[EnrichUDF], refstore: RefStore,
                     batch_size: int, model: str) -> Tuple[str, ...]:
    """Abstractly trace every stage against the tweet schema and the actual
    reference-table dtypes, on ``meta`` tensors — no FLOPs, no data.
    Returns the ordered output column names sinks will receive.  Raises
    ``PlanError`` naming the offending stage for any dtype/shape/column
    error, so misconfigured plans never reach a worker thread."""
    batch = _batch_struct(batch_size)
    cols = dict(batch)
    if fused is None:
        return tuple(cols)
    b = 1 if model == "per_record" else batch_size
    if model == "per_record":
        batch = _batch_struct(1)
        cols.update(batch)
    for stage in (fused.stages or (fused,)):
        refs = {}
        for t in stage.ref_tables:
            snap = refstore[t].snapshot()
            refs[t] = {k: _meta(v.shape, v.dtype)
                       for k, v in snap.arrays.items()}
        try:
            state = (stage.state_fn(refs)
                     if stage.state_fn is not None else ())
            out = stage.apply_fn(batch, state, refs)
        except PlanError:
            raise
        except Exception as e:
            raise PlanError(
                f"stage {stage.name!r} failed dtype/shape validation "
                "against the tweet schema and current reference tables: "
                f"{type(e).__name__}: {e}") from e
        if not isinstance(out, dict):
            raise PlanError(
                f"stage {stage.name!r} must return a dict of columns, "
                f"got {type(out).__name__}")
        for k, v in out.items():
            if not hasattr(v, "shape") or not v.shape or v.shape[0] != b:
                raise PlanError(
                    f"stage {stage.name!r} output {k!r} must be batch-"
                    f"aligned (leading dim {b}), got shape "
                    f"{getattr(v, 'shape', None)}")
            if k == "valid" and v.dtype != torch.bool:
                raise PlanError(
                    f"stage {stage.name!r} rewrites 'valid' with dtype "
                    f"{v.dtype}; filters must keep it bool")
        batch = dict(batch)
        batch.update(out)
        cols.update(out)
    return tuple(cols)
