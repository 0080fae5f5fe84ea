"""The computing job (§5.3, §6): parse -> build UDF state -> apply UDF.

Implements all three computing models the paper analyzes so the experiments
can compare them:

  Model 1 ``per_record``  state rebuilt and UDF applied per record — sees
                          every reference change, unusable at rate (§5.3.2)
  Model 2 ``per_batch``   the paper's choice: state rebuilt per *batch*,
                          refreshing reference changes at batch boundaries
  Model 3 ``stream``      state built once for the whole feed — fastest,
                          but blind to reference updates ("current w/o
                          updates" in §8.2) and exactly the stateful-UDF
                          failure mode of Fig 15/16

plus the **version-gated** refresh (beyond-paper, EXPERIMENTS.md §Perf):
Model-2 freshness at Model-3 cost while reference data is quiet — the state
is a pure function of the refstore version, so we rebuild only when the
version actually changed.

Both the state builder and the probe are predeployed (prepared once per
shape, see predeploy.py) and invoked per batch with (batch, refs) as
parameters.  Reference snapshots are device-cached by version so quiet
tables are not re-uploaded.  The runner works on one device: the card
unless the caller passes ``device="cpu"`` (``None`` raises without CUDA).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import records
from repro_torch.core.enrich.queries import EnrichUDF
from repro_torch.core.predeploy import PredeployCache
from repro_torch.core.refdata import RefSnapshot, RefStore


@dataclasses.dataclass
class StageStats:
    """Per-stage observability for fused (chained) UDFs: how often each
    stage's intermediate state was rebuilt vs reused and what it cost.
    Inside a multi-stage fused executable apply time cannot be attributed
    exactly per stage — the whole chain is ONE dispatch by design — so
    ``apply_s`` splits the batch's apply wall across the fused stages by
    **measured calibration fractions**: every ``CALIBRATE_EVERY``-th
    batch the runner replays the chain stage-by-stage through per-stage
    predeployed executables (compile excluded, off the hot path's
    accounting) and blends the observed shares into an EWMA weight per
    stage.  Until the first calibration lands the split is even — the
    pre-calibration behavior, still exact when the executable holds a
    single stage (the per-stage-split case the elasticity controller
    samples; model="per_record" also keeps the even split).  Exact
    *group*-level walls come from the tracer's ``apply.<group>`` spans
    (core/obs, docs/OBSERVABILITY.md)."""
    invocations: int = 0
    records: int = 0
    state_builds: int = 0
    state_reuses: int = 0
    state_s: float = 0.0
    apply_s: float = 0.0

    def merge(self, other: "StageStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class ComputingStats:
    invocations: int = 0
    records: int = 0
    parse_s: float = 0.0
    upload_s: float = 0.0
    convert_s: float = 0.0       # batch H2D + enriched-output D2H
    state_s: float = 0.0
    apply_s: float = 0.0
    state_builds: int = 0
    state_reuses: int = 0
    # stage-timing calibration passes taken (fused chains only); the
    # calibration walls themselves are NOT in apply_s — they price the
    # attribution, not the feed
    calibrations: int = 0
    # stage name -> StageStats, populated per enrichment stage (one entry
    # for a plain UDF, one per chained stage for a fused UDF)
    per_stage: Dict[str, StageStats] = dataclasses.field(
        default_factory=dict)

    def stage(self, name: str) -> StageStats:
        s = self.per_stage.get(name)
        if s is None:
            s = self.per_stage[name] = StageStats()
        return s

    def merge(self, other: "ComputingStats") -> None:
        for f in dataclasses.fields(self):
            if f.name == "per_stage":
                for name, ss in other.per_stage.items():
                    self.stage(name).merge(ss)
                continue
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass(frozen=True)
class ComputingSpec:
    udf: Optional[EnrichUDF]       # None = pure ingestion (no enrichment)
    batch_size: int
    model: str = "per_batch"       # per_record | per_batch | stream
    refresh: str = "always"        # always | version  (per_batch only)


class ComputingRunner:
    """One runner per computing-job worker.  Thread-confined."""

    def __init__(self, spec: ComputingSpec, refstore: RefStore,
                 cache: Optional[PredeployCache] = None,
                 device: DeviceLike = None):
        self.spec = spec
        self.refstore = refstore
        self.cache = cache or PredeployCache()
        self.device = resolve_device(device)
        self.stats = ComputingStats()
        self._device_refs: Dict[str, Tuple[int, Dict[str, torch.Tensor]]] = {}
        self._state = None            # (versions, state) for stream/gated
        self._state_versions: Optional[Tuple[int, ...]] = None
        # ref-version lineage of the LAST run() — the versions the batch
        # was actually enriched under (captured at snapshot time, so a ref
        # upsert racing the apply can never mark stored rows fresh).  The
        # feed tags storage-bound batches with this (core/repair.py).
        self.last_versions: Optional[Dict[str, int]] = None
        # fused UDFs: stage name -> (stage ref versions, state) so quiet
        # stages reuse their state while stale stages rebuild independently
        self._stage_states: Dict[str, Tuple[Tuple[int, ...], Any]] = {}
        # measured per-stage apply-time fractions (EWMA over calibration
        # passes); None until the first calibration -> even split
        self._stage_weights: Optional[Dict[str, float]] = None
        self._inv_since_cal = 0

    # ---------------------------------------------------------------- device
    def _upload(self, v: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(v)
        if not a.flags.writeable:   # torch.from_numpy wants a writable array
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def _sync(self) -> None:
        """Wait for the device where a wall time is taken (the work is
        queued asynchronously on the card)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- snapshots
    TRIM_QUANTUM = 256

    def _refs_to_device(self, snaps: Dict[str, RefSnapshot]
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Upload snapshots, trimmed to a quantized valid prefix.

        §Perf: tables carry UPSERT headroom (sentinel rows); probing the
        full capacity wastes a proportional slice of every per-row
        reference op (3x on Q6's district tables).  Trimming to
        round_up(size, 256) keeps shapes stable across small UPSERTs (the
        predeployed executable survives); crossing a quantum recompiles
        once — the paper's compile-once/invoke-many contract still holds
        per shape."""
        out = {}
        t0 = time.perf_counter()
        force = self.spec.refresh == "always" and self.spec.model != "stream"
        q = self.TRIM_QUANTUM
        for name, snap in snaps.items():
            hit = self._device_refs.get(name)
            if hit is not None and hit[0] == snap.version and not force:
                out[name] = hit[1]
                continue
            n = min(snap.capacity,
                    ((max(snap.size, 1) + q - 1) // q) * q)
            dev = {k: self._upload(v[:n]) for k, v in snap.arrays.items()}
            self._device_refs[name] = (snap.version, dev)
            out[name] = dev
        self.stats.upload_s += time.perf_counter() - t0
        return out

    # ----------------------------------------------------------------- state
    def _get_staged_state(self, refs, snaps: Dict[str, RefSnapshot]):
        """State for a fused UDF, built/refreshed per stage: each stage's
        state is keyed by the versions of the tables *that stage* reads, so
        under ``refresh="version"`` an upsert rebuilds only the stages it
        affects (Model-2 freshness per stage, Model-3 cost for the quiet
        ones).  ``refresh="always"`` rebuilds every stateful stage per
        batch, exactly like an unfused Model-2 UDF."""
        udf, spec = self.spec.udf, self.spec
        states = []
        for stage in udf.stages:
            if stage.state_fn is None:
                states.append(())
                continue
            ss = self.stats.stage(stage.name)
            sversions = tuple(snaps[t].version for t in stage.ref_tables)
            prev = self._stage_states.get(stage.name)
            reuse = prev is not None and (
                spec.model == "stream"
                or (spec.model == "per_batch"
                    and spec.refresh == "version"
                    and prev[0] == sversions))
            if reuse:
                ss.state_reuses += 1
                self.stats.state_reuses += 1
                states.append(prev[1])
                continue
            t0 = time.perf_counter()
            state = self.cache.invoke(f"state:{udf.name}:{stage.name}",
                                      stage.state_fn, refs)
            self._sync()
            dt = time.perf_counter() - t0
            ss.state_builds += 1
            ss.state_s += dt
            self.stats.state_builds += 1
            self.stats.state_s += dt
            self._stage_states[stage.name] = (sversions, state)
            states.append(state)
        return tuple(states)

    def _get_state(self, refs, versions):
        udf = self.spec.udf
        if udf.state_fn is None:
            return ()
        reuse = (
            (self.spec.model == "stream" and self._state is not None)
            or (self.spec.model == "per_batch"
                and self.spec.refresh == "version"
                and self._state_versions == versions))
        if reuse:
            self.stats.state_reuses += 1
            return self._state
        t0 = time.perf_counter()
        state = self.cache.invoke(f"state:{udf.name}", udf.build_state, refs)
        self._sync()
        self.stats.state_s += time.perf_counter() - t0
        self.stats.state_builds += 1
        self._state = state
        self._state_versions = versions
        return state

    # ----------------------------------------------------------------- parse
    def parse(self, frame) -> Dict[str, np.ndarray]:
        """Raw JSON-lines frame -> padded tensor records (a no-op for frames
        that arrive pre-parsed from a balanced intake).  Coalesced
        micro-batches exceeding the configured batch size are padded up to a
        power-of-two row bucket so the predeployed executables see a bounded
        set of shapes instead of one compile per coalesced size."""
        t0 = time.perf_counter()
        if isinstance(frame, dict):
            batch = frame
        else:
            batch = records.parse_json_lines(frame)
        size = self.spec.batch_size
        n = records.batch_rows(batch)
        if n > size and self.spec.model != "per_record":
            # per_record keeps pad_batch's loud oversize assert: its row
            # loop walks exactly batch_size rows, so a bucketed batch
            # would silently drop the tail
            from repro_torch.core.enrich import dispatch
            size = dispatch.bucket_rows(n, minimum=size)
        batch = records.pad_batch(batch, size)
        self.stats.parse_s += time.perf_counter() - t0
        return batch

    # ------------------------------------------------------------------- run
    def run(self, frame) -> Dict[str, np.ndarray]:
        """One computing-job invocation: returns the enriched batch
        (original columns + UDF outputs + valid mask), as numpy."""
        batch = self.parse(frame)
        nvalid = int(batch["valid"].sum())
        udf = self.spec.udf
        if udf is None:
            self.stats.invocations += 1
            self.stats.records += nvalid
            return batch

        snaps = self.refstore.snapshot(udf.ref_tables)
        versions = tuple(s.version for s in snaps.values())
        self.last_versions = dict(zip(snaps.keys(), versions))
        refs = self._refs_to_device(snaps)
        apply_before = self.stats.apply_s

        t0 = time.perf_counter()
        dev_batch = {k: self._upload(v) for k, v in batch.items()}
        self.stats.convert_s += time.perf_counter() - t0
        if self.spec.model == "per_record":
            enriched = self._run_per_record(dev_batch, refs, versions)
        else:
            if udf.stages and udf.state_fn is not None:
                state = self._get_staged_state(refs, snaps)
            else:
                state = self._get_state(refs, versions)
            t0 = time.perf_counter()
            enriched = self.cache.invoke(
                f"apply:{udf.name}", udf.apply_fn, dev_batch, state, refs)
            self._sync()
            self.stats.apply_s += time.perf_counter() - t0

        out = dict(batch)
        t0 = time.perf_counter()
        for k, v in enriched.items():
            out[k] = v.cpu().numpy()
        self.stats.convert_s += time.perf_counter() - t0
        self.stats.invocations += 1
        self.stats.records += nvalid
        stages = udf.stages or (udf,)
        # per-stage wall attribution: a fused chain is ONE dispatch, so
        # this batch's apply wall is split across its stages by measured
        # calibration fractions (even split until the first calibration;
        # see the StageStats docstring)
        weights = self._stage_weights
        if len(stages) > 1 and self.spec.model != "per_record":
            self._inv_since_cal += 1
            # first calibration at the CALIBRATE_EVERY-th fused batch —
            # NOT the first, so short feeds keep the strict one-dispatch
            # profile (and its predeploy-cache footprint) unchanged
            if self._inv_since_cal >= self.CALIBRATE_EVERY:
                weights = self._calibrate_stages(stages, dev_batch,
                                                 state, refs)
                self._inv_since_cal = 0
        batch_apply_s = self.stats.apply_s - apply_before
        even = 1.0 / len(stages)
        for st in stages:
            frac = weights.get(st.name, even) if weights else even
            ss = self.stats.stage(st.name)
            ss.invocations += 1
            ss.records += nvalid
            ss.apply_s += batch_apply_s * frac
        return out

    # ------------------------------------------------------------ calibration
    CALIBRATE_EVERY = 64     # fused-chain batches between stage re-timings

    def _calibrate_stages(self, stages, dev_batch, state, refs
                          ) -> Dict[str, float]:
        """Time each fused stage individually — the chain replayed through
        per-stage predeployed executables, outputs feeding forward exactly
        like the fused ``apply_fn`` — and blend the observed shares into
        the EWMA weights.  ``cache.get`` runs untimed first so a cold
        executable's compile never pollutes the measured fraction, and
        none of this wall lands in ``apply_s``: calibration prices the
        *attribution*, not the feed.  Per-stage executables share the
        predeploy cache with single-UDF feeds of the same stage (same
        (name, fn, signature) key)."""
        udf = self.spec.udf
        states = (state if udf.stages and udf.state_fn is not None
                  else ((),) * len(stages))
        durs: Dict[str, float] = {}
        cur = dict(dev_batch)
        for st, s in zip(stages, states):
            name = f"apply:{st.name}"
            self.cache.get(name, st.apply_fn, cur, s, refs)
            t0 = time.perf_counter()
            res = self.cache.invoke(name, st.apply_fn, cur, s, refs)
            self._sync()
            durs[st.name] = max(time.perf_counter() - t0, 1e-9)
            cur.update(res)
        total = sum(durs.values())
        fresh = {n: d / total for n, d in durs.items()}
        prev = self._stage_weights
        if prev is None:
            weights = fresh
        else:
            weights = {n: 0.5 * prev.get(n, f) + 0.5 * f
                       for n, f in fresh.items()}
            norm = sum(weights.values())
            weights = {n: w / norm for n, w in weights.items()}
        self._stage_weights = weights
        self.stats.calibrations += 1
        return weights

    def _run_per_record(self, dev_batch, refs, versions):
        """Model 1: per-record evaluation — state refreshed per record."""
        udf = self.spec.udf
        n = self.spec.batch_size
        outs = []
        for i in range(n):
            row = {k: v[i:i + 1] for k, v in dev_batch.items()}
            if udf.state_fn is None:
                state = ()
            else:
                t0 = time.perf_counter()
                state = self.cache.invoke(
                    f"state:{udf.name}", udf.build_state, refs)
                self.stats.state_s += time.perf_counter() - t0
                self.stats.state_builds += 1
            t0 = time.perf_counter()
            o = self.cache.invoke(
                f"apply1:{udf.name}", udf.apply_fn, row, state, refs)
            self._sync()
            outs.append(o)
            self.stats.apply_s += time.perf_counter() - t0
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
