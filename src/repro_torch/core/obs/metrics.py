"""Unified metrics registry: counters, gauges, fixed-bucket histograms.

One ``MetricsRegistry`` per feed (``FeedHandle.obs.registry``) replaces
the scattered ad-hoc stats surfaces as the *storage* for runtime
telemetry: the public stats dataclasses (``FeedStats`` first) keep their
attribute API but read/write *through* the registry, so every number a
benchmark or operator wants is also a live, uniformly-named metric
(``handle.metrics()``) and a Prometheus-style text dump
(``handle.metrics_text()``).

Concurrency contract (docs/CONCURRENCY.md, enforced by feedlint R6):

* ``Counter.inc``/``set`` and ``Gauge.set`` are **lock-free** single
  attribute updates.  They are safe under any core lock (that is what
  makes registry-backed ``FeedStats`` possible — its mutations happen
  under the handle lock exactly as before) and their writers are either
  single-threaded or already externally serialized, the same
  racy-by-design discipline as the holder wait counters.
* ``Histogram.observe`` serializes on a small per-instrument lock
  (global name ``metrics``) because histograms have genuinely concurrent
  writers (worker backlog samples).  Rule R6 therefore requires
  ``observe`` to run with **no core lock held** (``blocking-ok``
  step locks exempt, with declared ``LOCK_ORDER`` edges).
* ``snapshot()``/``exposition()`` read instrument fields lock-free
  (GIL-atomic reference reads; a mid-observe read can skew sum vs count
  by one sample, which is harmless for telemetry) while holding only
  the registry map lock.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Mapping, Tuple, Union

#: default bucket bounds for latency histograms (seconds, log-spaced)
SECONDS_BOUNDS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: default bucket bounds for row-count histograms (powers of two)
ROWS_BOUNDS: Tuple[float, ...] = (
    0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
    1024.0, 4096.0, 16384.0, 65536.0, 262144.0)

#: raw-sample ring bound per histogram — exact percentiles over the
#: newest ~4K observations (same halving policy as RepairStats)
MAX_SAMPLES = 4096

_NAME_RE = re.compile(r"[^A-Za-z0-9_]")


def mangle(name: str) -> str:
    """Label-free exposition names: anything outside ``[A-Za-z0-9_]``
    becomes ``_`` (dispatch path keys like ``('segment_sum', 'kernel')``
    publish as ``dispatch_path_segment_sum_kernel``)."""
    return _NAME_RE.sub("_", name)


class Counter:
    """Monotonic-by-convention integer.  Lock-free: writers are single-
    threaded or externally serialized (see module docstring)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += int(n)

    def set(self, value: int) -> None:
        """Absolute set — what ``stats.field += n`` under the owner's
        lock compiles to through the registry-backed dataclasses."""
        self._value = int(value)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins float.  Lock-free, same contract as Counter."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def add(self, delta: float) -> None:
        self._value += float(delta)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram + bounded raw-sample ring.

    The buckets feed the Prometheus-style exposition; the ring gives
    exact percentiles over the newest ``MAX_SAMPLES`` observations
    (benchmarks compare these against independently driver-computed
    lags, so approximation error from bucket interpolation is not
    acceptable there).
    """

    __slots__ = ("name", "bounds", "_lock", "_counts", "_overflow",
                 "_sum", "_count", "_samples")

    def __init__(self, name: str, bounds: Tuple[float, ...] = SECONDS_BOUNDS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram bounds must be sorted: {bounds}")
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        # one small lock per instrument, never held across blocking work;
        # observe() has concurrent writers (e.g. worker backlog samples)
        self._lock = threading.Lock()      # lock-name: metrics
        self._counts = [0] * len(self.bounds)  # write-guarded-by: _lock
        self._overflow = 0                 # write-guarded-by: _lock
        self._sum = 0.0                    # write-guarded-by: _lock
        self._count = 0                    # write-guarded-by: _lock
        self._samples: List[float] = []    # write-guarded-by: _lock

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._overflow += 1
            self._samples.append(v)
            if len(self._samples) > MAX_SAMPLES:
                # keep the newest half: recent currency matters most
                del self._samples[:len(self._samples) // 2]

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """Exact percentile over the retained raw samples (lock-free
        copy of the bounded ring; ``nan`` when never observed — a
        percentile of an empty distribution is undefined, and 0.0 used
        to read as "instant", which is a lie health rules would act
        on)."""
        return percentile_of(tuple(self._samples), q)


class HistogramSnapshot:
    """Immutable point-in-time view of one histogram."""

    __slots__ = ("name", "bounds", "bucket_counts", "overflow", "sum",
                 "count", "samples")

    def __init__(self, name: str, bounds: Tuple[float, ...],
                 bucket_counts: Tuple[int, ...], overflow: int,
                 total: float, count: int, samples: Tuple[float, ...]):
        self.name = name
        self.bounds = bounds
        self.bucket_counts = bucket_counts
        self.overflow = overflow
        self.sum = total
        self.count = count
        self.samples = samples

    def percentile(self, q: float) -> float:
        """Exact percentile over the retained raw samples (``nan`` when
        the histogram has never been observed — undefined, not zero;
        callers wanting a default test ``count`` or ``math.isnan``)."""
        xs = sorted(self.samples)
        if not xs:
            return math.nan
        return float(xs[min(len(xs) - 1, int(q * len(xs)))])

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """``(le, cumulative_count)`` per bound, exposition-style."""
        out, acc = [], 0
        for b, c in zip(self.bounds, self.bucket_counts):
            acc += c
            out.append((b, acc))
        return out

    def __repr__(self) -> str:
        return (f"HistogramSnapshot({self.name!r}, count={self.count}, "
                f"sum={self.sum:.6g}, p50={self.percentile(0.5):.6g}, "
                f"p95={self.percentile(0.95):.6g})")


MetricValue = Union[int, float, HistogramSnapshot]


def _fmt(v: float) -> str:
    """Exposition number formatting: integral floats print as ints."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.9g}"


class MetricsRegistry:
    """Name -> instrument map.  ``counter``/``gauge``/``histogram`` are
    get-or-create; ``snapshot()`` returns an isolated mapping (ints,
    floats, ``HistogramSnapshot``); ``exposition()`` is the Prometheus
    text format; ``merge()`` folds another registry in (counters add,
    gauges last-write-wins, histograms add bucket-wise)."""

    def __init__(self) -> None:
        # guards only the name->instrument map (instruments synchronize
        # themselves); never held across blocking work
        self._lock = threading.Lock()  # lock-name: metrics-registry
        self._counters: Dict[str, Counter] = {}    # guarded-by: _lock
        self._gauges: Dict[str, Gauge] = {}        # guarded-by: _lock
        self._hists: Dict[str, Histogram] = {}     # guarded-by: _lock

    # ------------------------------------------------------------- factories
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                self._check_free_locked(name, self._counters)
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                self._check_free_locked(name, self._gauges)
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,
                  bounds: Tuple[float, ...] = SECONDS_BOUNDS) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                self._check_free_locked(name, self._hists)
                h = self._hists[name] = Histogram(name, bounds)
            return h

    def _check_free_locked(self, name: str, own: Dict) -> None:  # requires-lock: _lock
        for kind, reg in (("counter", self._counters),
                          ("gauge", self._gauges),
                          ("histogram", self._hists)):
            if reg is not own and name in reg:
                raise ValueError(
                    f"metric {name!r} already registered as a {kind}")

    # --------------------------------------------------------------- reading
    def snapshot(self) -> Dict[str, MetricValue]:
        """Isolated point-in-time view: mutating the registry (or
        observing instruments) after this call never changes a returned
        snapshot."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._hists.values())
        out: Dict[str, MetricValue] = {}
        for c in counters:
            out[c.name] = c.value
        for g in gauges:
            out[g.name] = g.value
        for h in hists:
            out[h.name] = HistogramSnapshot(
                h.name, h.bounds, tuple(h._counts), h._overflow,
                h._sum, h._count, tuple(h._samples))
        return out

    def exposition(self) -> str:
        """Prometheus text exposition (label-free names; histogram
        buckets use the standard ``_bucket{le=...}`` convention)."""
        snap = self.snapshot()
        lines: List[str] = []
        for name in sorted(snap):
            v = snap[name]
            m = mangle(name)
            if isinstance(v, HistogramSnapshot):
                lines.append(f"# TYPE {m} histogram")
                for le, acc in v.cumulative_buckets():
                    lines.append(f'{m}_bucket{{le="{_fmt(le)}"}} {acc}')
                lines.append(f'{m}_bucket{{le="+Inf"}} {v.count}')
                lines.append(f"{m}_sum {_fmt(v.sum)}")
                lines.append(f"{m}_count {v.count}")
            elif isinstance(v, int):
                lines.append(f"# TYPE {m} counter")
                lines.append(f"{m} {v}")
            else:
                lines.append(f"# TYPE {m} gauge")
                lines.append(f"{m} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    # --------------------------------------------------------------- merging
    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry: counters add, gauges take
        the other's value, histograms add bucket-wise and concatenate
        sample rings (bounded).  ``other`` is snapshotted first, so the
        two registry locks are never nested."""
        data = other.snapshot()
        for name, v in data.items():
            if isinstance(v, HistogramSnapshot):
                h = self.histogram(name, v.bounds)
                with h._lock:
                    if h.bounds != v.bounds:
                        raise ValueError(
                            f"histogram {name!r} bucket bounds differ")
                    for i, c in enumerate(v.bucket_counts):
                        h._counts[i] += c
                    h._overflow += v.overflow
                    h._sum += v.sum
                    h._count += v.count
                    h._samples.extend(v.samples)
                    if len(h._samples) > MAX_SAMPLES:
                        del h._samples[:len(h._samples) - MAX_SAMPLES]
            elif isinstance(v, int):
                c2 = self.counter(name)
                c2.inc(v)
            else:
                self.gauge(name).set(v)

    # ------------------------------------------------------------- utilities
    def set_counters(self, values: Mapping[str, int]) -> None:
        for name, v in values.items():
            self.counter(name).set(int(v))

    def set_gauges(self, values: Mapping[str, float]) -> None:
        for name, v in values.items():
            self.gauge(name).set(float(v))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(list(self._counters) + list(self._gauges)
                          + list(self._hists))


def percentile_of(values: Iterable[float], q: float) -> float:
    """Shared sorted-rank percentile (the RepairStats convention).
    Returns ``nan`` for an empty input: a percentile of no samples is
    undefined, and the old 0.0 masked "never observed" as "instant"."""
    xs = sorted(values)
    if not xs:
        return math.nan
    return float(xs[min(len(xs) - 1, int(q * len(xs)))])


__all__ = ["Counter", "Gauge", "Histogram", "HistogramSnapshot",
           "MetricsRegistry", "MetricValue", "SECONDS_BOUNDS",
           "ROWS_BOUNDS", "MAX_SAMPLES", "mangle", "percentile_of"]
