"""feedscope: per-feed health states from declarative SLO rules.

A ``FeedHealthModel`` evaluates a metrics snapshot (the mapping
``FeedHandle.metrics()`` returns) against a small, declarative rule set
(``HealthSpec``) and yields one of three states:

  ``ok``        every rule passes
  ``degraded``  an SLO rule tripped but the feed is still moving
  ``stalled``   outstanding work exists and *no progress* has been made
                for longer than ``stall_after_s``

Rules (each one line of the ``/health`` report; thresholds in
``HealthSpec``):

| rule              | signal (registry instrument)                  |
|-------------------|-----------------------------------------------|
| visible_latency   | ``ingest_visible_latency_s`` p95 over budget  |
| wal_fsync         | ``wal_fsync_s`` p95 over budget               |
| repair_currency   | ``repair_currency_s`` p95 vs the repair SLO   |
|                   | (``max_lag_s`` x ``repair_lag_slack``)        |
| worker_errors     | ``worker_errors`` counter over the allowance  |
| backlog_growth    | ``backlog_rows_now`` strictly increasing over |
|                   | ``backlog_growth_evals`` evaluations          |
| stalled           | ``backlog_rows_now`` > 0 while the progress   |
|                   | counters (``feed_stored`` + ``sink_*_batches``|
|                   | pulls) sit still for > ``stall_after_s``      |

Empty histograms are skipped, not judged: their percentiles are ``nan``
by design (core/obs/metrics.py), and ``nan > x`` is False anyway — a
never-observed latency is "no data", never "instant".

The model is **clock-injectable** (pass ``clock=`` a fake monotonic
callable) so stall and growth transitions unit-test without sleeping.
Evaluations serialize on a private lock (``health``) held only around
pure in-memory bookkeeping — no other lock, no blocking call, and no
``observe``/``emit`` ever runs under it, so feedlint's lock hierarchy
gains no edges.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional

from repro_torch.core.obs.metrics import HistogramSnapshot

OK = "ok"
DEGRADED = "degraded"
STALLED = "stalled"

#: state -> ``feed_health`` gauge encoding (worst wins)
STATE_CODE: Dict[str, int] = {OK: 0, DEGRADED: 1, STALLED: 2}


@dataclasses.dataclass(frozen=True)
class HealthSpec:
    """Declarative SLO thresholds (``.options(health=...)``).  A rule
    whose signal is absent from the snapshot — no WAL, no repair, never
    observed — passes by definition."""
    visible_p95_s: float = 5.0       # store-visible latency budget
    wal_fsync_p95_s: float = 1.0     # durable-feed fsync budget
    repair_lag_slack: float = 2.0    # degraded past slack * max_lag_s
    max_worker_errors: int = 0       # tolerated worker-loop errors
    backlog_growth_evals: int = 3    # monotone growth across N evals
    stall_after_s: float = 5.0       # no progress w/ backlog -> stalled

    def __post_init__(self):
        if self.backlog_growth_evals < 2:
            raise ValueError("backlog_growth_evals must be >= 2")
        if self.stall_after_s <= 0:
            raise ValueError("stall_after_s must be > 0")


@dataclasses.dataclass
class HealthReport:
    """One evaluation's outcome.  ``state`` is the worst rule outcome,
    ``code`` its ``feed_health`` gauge encoding, ``rules`` every rule's
    own state, and ``reasons`` one human line per non-ok rule."""
    state: str = OK
    code: int = 0
    rules: Dict[str, str] = dataclasses.field(default_factory=dict)
    reasons: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _p95(snap: Mapping[str, Any], name: str) -> Optional[float]:
    """p95 of a histogram snapshot, or None when absent/never observed
    (empty percentiles are nan by design — treat as no data)."""
    h = snap.get(name)
    if not isinstance(h, HistogramSnapshot) or not h.count:
        return None
    return h.percentile(0.95)


class FeedHealthModel:
    """Stateful rule evaluator for ONE feed.  Keep one instance per feed
    (the growth/stall rules compare consecutive evaluations); hand every
    ``evaluate`` call the feed's current ``metrics()`` snapshot."""

    def __init__(self, spec: Optional[HealthSpec] = None,
                 max_lag_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.spec = spec or HealthSpec()
        self.max_lag_s = max_lag_s   # repair SLO (None = rule disabled)
        self._clock = clock
        # pure in-memory bookkeeping only — nothing blocking, no other
        # lock, no observe/emit ever runs under it
        self._lock = threading.Lock()         # lock-name: health
        self._backlogs: Deque[float] = collections.deque(
            maxlen=self.spec.backlog_growth_evals)  # guarded-by: _lock
        self._progress: Optional[float] = None      # guarded-by: _lock
        self._progress_t = 0.0                      # guarded-by: _lock

    # ------------------------------------------------------------- evaluate
    def evaluate(self, snap: Mapping[str, Any]) -> HealthReport:
        spec = self.spec
        report = HealthReport()

        def rule(name: str, state: str, reason: str = "") -> None:
            report.rules[name] = state
            if state != OK:
                report.reasons.append(f"{name}: {reason}")
            if STATE_CODE[state] > report.code:
                report.state = state
                report.code = STATE_CODE[state]

        p = _p95(snap, "ingest_visible_latency_s")
        rule("visible_latency",
             DEGRADED if p is not None and p > spec.visible_p95_s else OK,
             f"p95 {p:.3f}s > {spec.visible_p95_s:.3f}s budget"
             if p is not None else "")

        p = _p95(snap, "wal_fsync_s")
        rule("wal_fsync",
             DEGRADED if p is not None and p > spec.wal_fsync_p95_s else OK,
             f"p95 {p:.3f}s > {spec.wal_fsync_p95_s:.3f}s budget"
             if p is not None else "")

        p = _p95(snap, "repair_currency_s")
        lag_budget = (self.max_lag_s * spec.repair_lag_slack
                      if self.max_lag_s is not None else None)
        rule("repair_currency",
             DEGRADED if (p is not None and lag_budget is not None
                          and p > lag_budget) else OK,
             f"p95 {p:.3f}s > {lag_budget:.3f}s "
             f"(max_lag_s x {spec.repair_lag_slack:g})"
             if p is not None and lag_budget is not None else "")

        errs = int(snap.get("worker_errors", 0) or 0)
        rule("worker_errors",
             DEGRADED if errs > spec.max_worker_errors else OK,
             f"{errs} worker error(s) (allowed {spec.max_worker_errors})")

        backlog = float(snap.get("backlog_rows_now", 0.0) or 0.0)
        progress = float(snap.get("feed_stored", 0) or 0)
        progress += sum(float(v) for k, v in snap.items()
                        if k.startswith("sink_") and k.endswith("_batches")
                        and isinstance(v, (int, float)))
        now = self._clock()
        with self._lock:
            self._backlogs.append(backlog)
            growing = (len(self._backlogs) ==
                       self._backlogs.maxlen and
                       all(a < b for a, b in zip(list(self._backlogs),
                                                 list(self._backlogs)[1:])))
            if self._progress is None or progress != self._progress \
                    or backlog <= 0.0:
                # progress moved (or nothing is outstanding): re-anchor
                self._progress = progress
                self._progress_t = now
            stalled_for = now - self._progress_t
        rule("backlog_growth", DEGRADED if growing else OK,
             f"backlog grew monotonically over the last "
             f"{spec.backlog_growth_evals} evaluations "
             f"(now {backlog:.0f} rows)")
        rule("stalled",
             STALLED if (backlog > 0.0
                         and stalled_for > spec.stall_after_s) else OK,
             f"{backlog:.0f} rows outstanding with no progress for "
             f"{stalled_for:.1f}s (> {spec.stall_after_s:.1f}s)")
        return report


__all__ = ["DEGRADED", "FeedHealthModel", "HealthReport", "HealthSpec",
           "OK", "STALLED", "STATE_CODE"]
