"""Per-stage elasticity (ROADMAP: scale the partitions of a *stage*, not
the feed): a closed loop from observed load to partition count.

The paper's framework *adapts* — to reference-data changes (Model 2) and,
here, to load.  ``ElasticityController`` is one monitor thread per feed
that, at a configurable cadence, samples every stage group's

  * holder backlog (rows + bytes queued, ``PartitionHolder.backlog``), and
  * per-stage ``ComputingStats`` (apply_s / invocations / records of the
    group's runners — the per-stage split makes apply time attributable),

and drives ``FeedHandle.scale_up`` / ``FeedHandle.scale_down`` between the
``min_partitions``/``max_partitions`` bounds of the group's ``ElasticSpec``
(declared on the plan via ``pipeline(...).options(elastic=...)`` feed-wide,
or per stage via ``.enrich(udf, partitions=..., elastic=...)``).

Control law (deliberately simple and hysteretic):

  scale UP   when backlog rows exceed ``high_watermark`` batches *per
             partition* for ``up_after`` consecutive samples;
  scale DOWN when backlog rows stay under ``low_watermark`` batches total
             for ``down_after`` consecutive samples;

both gated by a shared per-group ``cooldown_s`` so the loop cannot flap,
and both stepping at most ``max_step`` partitions per decision.  Why
backlog and not utilization: enrichment-operator parallelism is what
bounds sustainable throughput (arXiv:2307.14287) and queued rows are the
direct, cheap observable of that bound being exceeded — a stage whose
workers keep up has an empty queue regardless of how hot they run.

``step()`` is synchronous and side-effect-complete so the control law is
unit-testable without threads; ``run()`` is just step + sleep until the
feed's workers are gone.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, NamedTuple, Optional


@dataclasses.dataclass(frozen=True)
class ElasticSpec:
    """Elastic bounds + control-law knobs for one stage group (or, when set
    via ``options(elastic=...)``, the default for every group of the plan).
    ``min_partitions == max_partitions`` pins the group static while still
    enabling backlog sampling (the benchmarks use this for fair A/Bs)."""
    min_partitions: int = 1
    max_partitions: int = 4
    interval_s: float = 0.05       # controller sampling cadence
    high_watermark: float = 1.5    # backlog batches per partition -> up
    low_watermark: float = 0.25    # backlog batches total -> down
    up_after: int = 2              # consecutive high samples before up
    down_after: int = 8            # consecutive low samples before down
    cooldown_s: float = 0.25       # min seconds between actions per group
    max_step: int = 1              # partitions added/retired per decision

    def __post_init__(self):
        if not (1 <= self.min_partitions <= self.max_partitions):
            raise ValueError(
                "elastic bounds must satisfy 1 <= min <= max, got "
                f"min={self.min_partitions} max={self.max_partitions}")
        if self.interval_s <= 0 or self.cooldown_s < 0:
            raise ValueError("interval_s must be > 0, cooldown_s >= 0")
        if self.up_after < 1 or self.down_after < 1 or self.max_step < 1:
            raise ValueError("up_after, down_after, max_step must be >= 1")


class GroupSample(NamedTuple):
    """One controller observation of one stage group."""
    t: float
    gid: int
    partitions: int
    backlog_rows: int
    backlog_bytes: int
    apply_s: float          # cumulative, summed over the group's runners
    invocations: int
    records: int


class Decision(NamedTuple):
    t: float
    gid: int
    action: str             # "up" | "down"
    partitions: int         # partition count AFTER the action


class ElasticityController(threading.Thread):
    """Per-feed monitor thread closing the load -> partitions loop.

    Operates on the feed handle's stage-group runtimes through a narrow
    protocol — each group exposes ``gid``, ``name``, ``elastic``,
    ``holders`` (list of objects with ``backlog()``) and ``slots`` (worker
    records with a ``runner.stats``), and the handle exposes
    ``stage_groups``, ``scale_up(n, stage=)``, ``scale_down(n, stage=)`` —
    so the control law is testable against fakes (tests/test_elasticity.py)
    and reusable by future per-stage *placement* monitors."""

    MAX_SAMPLES = 4096      # ring buffer bound: newest observations win

    def __init__(self, handle, batch_size: int,
                 name: str = "elasticity"):
        super().__init__(name=f"{name}-controller", daemon=True)
        self.handle = handle
        self.batch_size = max(1, batch_size)
        self.samples: List[GroupSample] = []    # guarded-by: _lock
        self.decisions: List[Decision] = []     # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._up_ticks: Dict[int, int] = {}
        self._down_ticks: Dict[int, int] = {}
        self._last_action: Dict[int, float] = {}
        self._lock = threading.Lock()           # lock-name: controller

    # ----------------------------------------------------------- the loop
    def run(self) -> None:
        interval = min((g.elastic.interval_s
                        for g in self.handle.stage_groups
                        if g.elastic is not None), default=0.05)
        while not self._stop_evt.wait(interval):
            try:
                self.step()
            except Exception:
                # the controller must never take the feed down; a failed
                # sample just skips one control period
                continue
            if not any(s.thread is not None and s.thread.is_alive()
                       for g in self.handle.stage_groups
                       for s in list(g.slots)):
                return

    def stop(self) -> None:
        self._stop_evt.set()

    # ------------------------------------------------------- control law
    def step(self, now: Optional[float] = None) -> None:
        """One sample + decide pass over every stage group.  ``now`` is
        injectable so the hysteresis/cooldown clock is test-controllable."""
        t = time.monotonic() if now is None else now
        for group in list(self.handle.stage_groups):
            rows = nbytes = 0
            for h in list(group.holders):
                r, b = h.backlog()
                rows += r
                nbytes += b
            apply_s, inv, rec = 0.0, 0, 0
            for slot in list(group.slots):
                st = slot.runner.stats
                apply_s += st.apply_s
                inv += st.invocations
                rec += st.records
            parts = len(group.holders)
            with self._lock:
                self.samples.append(GroupSample(
                    t, group.gid, parts, rows, nbytes, apply_s, inv, rec))
                if len(self.samples) > self.MAX_SAMPLES:
                    del self.samples[:len(self.samples) // 2]
            spec = group.elastic
            if spec is None or parts == 0:
                continue
            self._decide(group, spec, parts, rows, t)

    def _decide(self, group, spec: ElasticSpec, parts: int, rows: int,
                t: float) -> None:
        gid = group.gid
        high = spec.high_watermark * self.batch_size * parts
        low = spec.low_watermark * self.batch_size
        if rows > high and parts < spec.max_partitions:
            self._up_ticks[gid] = self._up_ticks.get(gid, 0) + 1
        else:
            self._up_ticks[gid] = 0
        if rows < low and parts > spec.min_partitions:
            self._down_ticks[gid] = self._down_ticks.get(gid, 0) + 1
        else:
            self._down_ticks[gid] = 0

        cool = t - self._last_action.get(gid, -1e9) >= spec.cooldown_s
        if self._up_ticks[gid] >= spec.up_after and cool:
            step = min(spec.max_step, spec.max_partitions - parts)
            added = self.handle.scale_up(step, stage=gid)
            if added:
                self._last_action[gid] = t
                self._up_ticks[gid] = 0
                with self._lock:
                    self.decisions.append(
                        Decision(t, gid, "up", parts + added))
        elif self._down_ticks[gid] >= spec.down_after and cool:
            step = min(spec.max_step, parts - spec.min_partitions)
            dropped = self.handle.scale_down(step, stage=gid)
            if dropped:
                self._last_action[gid] = t
                self._down_ticks[gid] = 0
                with self._lock:
                    self.decisions.append(
                        Decision(t, gid, "down", parts - dropped))

    # ---------------------------------------------------- observability
    def backlog_p95(self, gid: int = 0) -> float:
        """p95 of sampled backlog rows for one group (benchmark metric)."""
        with self._lock:
            rows = sorted(s.backlog_rows for s in self.samples
                          if s.gid == gid)
        if not rows:
            return 0.0
        return float(rows[min(len(rows) - 1, int(0.95 * len(rows)))])

    def partition_timeline(self, gid: int = 0) -> List[int]:
        with self._lock:
            return [s.partitions for s in self.samples if s.gid == gid]
