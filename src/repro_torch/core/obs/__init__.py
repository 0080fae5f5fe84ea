"""Feed observability: trace spans, unified metrics, currency accounting.

``FeedObs`` is the per-feed bundle every pipeline component shares: a
``MetricsRegistry`` (always on — counters/gauges are lock-free attribute
updates, histograms a tiny per-instrument lock) and an optional
``Tracer`` (opt-in via ``.options(trace=...)``; ``obs.emit`` is a no-op
when tracing is off, so instrumentation sites never branch on policy).

Lock discipline (feedlint R6, docs/CONCURRENCY.md): histogram
``observe`` and span ``emit`` must run with no core lock held
(``blocking-ok`` step locks exempt, with declared lock-order edges);
counter/gauge updates are allowed anywhere.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.obs.health import (FeedHealthModel, HealthReport,
                                   HealthSpec, STATE_CODE)
from repro_torch.core.obs.metrics import (Counter, Gauge, Histogram,
                                    HistogramSnapshot, MetricsRegistry,
                                    MetricValue, ROWS_BOUNDS,
                                    SECONDS_BOUNDS, mangle, percentile_of)
from repro_torch.core.obs.profile import (HOP_ORDER, HopStats, JourneyProfiler,
                                    ProfileReport, ProfileSpec)
from repro_torch.core.obs.server import ObsServer, http_get
from repro_torch.core.obs.trace import Tracer, TraceSpec, write_jsonl


class FeedObs:
    """One feed's observability bundle: registry (always) + tracer
    (when a ``TraceSpec`` is enabled)."""

    def __init__(self, trace: Optional[TraceSpec] = None):
        self.registry = MetricsRegistry()
        self.trace_spec: Optional[TraceSpec] = trace
        self.tracer: Optional[Tracer] = \
            Tracer(trace.capacity) if trace is not None else None

    def enable_trace(self, spec: TraceSpec) -> None:
        self.trace_spec = spec
        self.tracer = Tracer(spec.capacity)

    @property
    def tracing(self) -> bool:
        return self.tracer is not None

    def new_span(self) -> int:
        """Fresh span id, or 0 when tracing is off (0 never collides —
        real ids start at 1)."""
        tr = self.tracer
        return tr.new_id() if tr is not None else 0

    def emit(self, name: str, spans: Tuple[int, ...] = (), t0: float = 0.0,
             dur: float = 0.0, **extra: Any) -> None:
        """Emit one span; no-op when tracing is off.  Subject to
        feedlint R6: never call while holding a core lock."""
        tr = self.tracer
        if tr is not None:
            tr.emit(name, spans, t0, dur, **extra)

    def drain_trace(self) -> List[Dict[str, Any]]:
        tr = self.tracer
        return tr.drain() if tr is not None else []


__all__ = ["FeedObs", "MetricsRegistry", "MetricValue", "Counter", "Gauge",
           "Histogram", "HistogramSnapshot", "Tracer", "TraceSpec",
           "SECONDS_BOUNDS", "ROWS_BOUNDS", "mangle", "percentile_of",
           "write_jsonl",
           "FeedHealthModel", "HealthReport", "HealthSpec", "STATE_CODE",
           "HOP_ORDER", "HopStats", "JourneyProfiler", "ProfileReport",
           "ProfileSpec", "ObsServer", "http_get"]
