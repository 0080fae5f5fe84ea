"""feedscope: journey reconstruction and critical-path attribution.

Turns the tracer's flat span stream (core/obs/trace.py) into *batch
journeys* — one per tracked batch, grouped by span id across the hop
taxonomy ``intake.draw -> wal.append -> coalesce -> apply.<group> ->
sink.append -> store.append -> store.flush`` — and decomposes each
journey's end-to-end visible latency into per-hop **service** time (the
span's own ``dur``) and **queue** time (the gap between one hop's end
and the next hop's start, attributed to the hop that was waited *for*).

Span ids merge at coalesce points (several intake draws become one
apply) and at segment flushes (many store-appends become one flush);
the profiler unions them, so a journey is the connected component of
span ids, found with a tiny union-find.

``JourneyProfiler.report()`` rolls the retained window up into a
``ProfileReport``: per-hop p50/p95 for service and queue, each hop's
**critical-path fraction** (its share of all attributed wall time),
and a ranked bottleneck verdict.  ``FeedHandle.profile()`` feeds it
from ``drain_trace()`` and publishes ``bottleneck_<hop>_frac`` gauges;
the live ops endpoint (core/obs/server.py) serves the JSON form at
``/profile``.

Thread safety: ingest/report/recent_spans serialize on a private lock
(``profiler``) that is never held around any other lock, any blocking
call, or any ``observe``/``emit`` — feedlint sees no new ordering
edges.  Span draining happens *outside* the profiler (the caller hands
in already-drained copies), so the ``trace-rings`` lock never nests
under it either.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.core.obs.metrics import percentile_of

#: canonical hop display order; unknown hops (repair.unit, custom) sort
#: after these, alphabetically
HOP_ORDER: Tuple[str, ...] = ("intake.draw", "wal.append", "coalesce",
                              "apply.", "sink.append", "store.append",
                              "store.flush")


def _hop_rank(name: str) -> Tuple[int, str]:
    for i, prefix in enumerate(HOP_ORDER):
        if name == prefix or (prefix.endswith(".") and
                              name.startswith(prefix)):
            return (i, name)
    return (len(HOP_ORDER), name)


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    """Profiler policy (``.options(profile=...)``).  ``window`` bounds
    the number of retained journeys (oldest evicted); ``trace_keep``
    bounds the raw spans kept for the ``/trace`` endpoint."""
    window: int = 512
    trace_keep: int = 512

    def __post_init__(self):
        if self.window <= 0:
            raise ValueError("profile window must be > 0")
        if self.trace_keep <= 0:
            raise ValueError("profile trace_keep must be > 0")


@dataclasses.dataclass
class HopStats:
    """One hop's aggregate over the journey window.  ``service_s`` sums
    span durations, ``queue_s`` sums the waits attributed to this hop
    (time between the previous hop's end and this hop's start), and
    ``frac`` is the hop's critical-path fraction: (service + queue) /
    total attributed time across all hops."""
    hop: str
    count: int = 0
    service_s: float = 0.0
    queue_s: float = 0.0
    service_p50: float = 0.0
    service_p95: float = 0.0
    queue_p50: float = 0.0
    queue_p95: float = 0.0
    frac: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ProfileReport:
    """Rolling critical-path profile over the retained journey window.

    ``bottleneck`` is the verdict: the hop with the largest critical-path
    fraction (``None`` until at least one journey reconstructs);
    ``ranked`` is every hop sorted by fraction, descending.  ``visible``
    percentiles cover journeys anchored at ``intake.draw``; a journey is
    ``complete`` when it runs intake.draw -> ... -> store.flush."""
    journeys: int = 0
    complete: int = 0
    hops: Dict[str, HopStats] = dataclasses.field(default_factory=dict)
    ranked: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    bottleneck: Optional[str] = None
    visible_p50_s: float = 0.0
    visible_p95_s: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"journeys": self.journeys,
                "complete": self.complete,
                "bottleneck": self.bottleneck,
                "ranked": [list(r) for r in self.ranked],
                "visible_p50_s": self.visible_p50_s,
                "visible_p95_s": self.visible_p95_s,
                "hops": {h: s.to_dict() for h, s in self.hops.items()}}


class _Journey:
    __slots__ = ("hops", "born")

    def __init__(self, born: int):
        # (t0, dur, name) per observed hop span, unsorted until report
        self.hops: List[Tuple[float, float, str]] = []
        self.born = born


class JourneyProfiler:
    """Reconstructs batch journeys from drained spans and rolls them up
    into ``ProfileReport``s.  Feed it with ``ingest(spans)`` (the spans
    must already be drained — the profiler never touches the tracer),
    then ask for ``report()``."""

    def __init__(self, spec: Optional[ProfileSpec] = None):
        self.spec = spec or ProfileSpec()
        # serializes ingest/report/recent_spans; pure in-memory work
        # only — never held around observe/emit or any other lock
        self._lock = threading.Lock()          # lock-name: profiler
        self._parent: Dict[int, int] = {}      # guarded-by: _lock
        self._journeys: Dict[int, _Journey] = {}   # guarded-by: _lock
        self._born = 0                         # guarded-by: _lock
        self._recent: Deque[Dict[str, Any]] = collections.deque(
            maxlen=self.spec.trace_keep)       # guarded-by: _lock

    # ------------------------------------------------------------ union-find
    def _find(self, x: int) -> int:  # requires-lock: _lock
        parent = self._parent
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:     # path compression
            parent[x], x = root, parent[x]
        return root

    def _union(self, a: int, b: int) -> int:  # requires-lock: _lock
        ra, rb = self._find(a), self._find(b)
        if ra == rb:
            return ra
        # an evicted journey can resurface via a late span: treat its
        # root as empty rather than KeyError-ing the ingest loop
        ja = self._journeys.get(ra)
        jb = self._journeys.get(rb)
        if ja is None and jb is None:
            self._parent[rb] = ra
            return ra
        if ja is None or (jb is not None and jb.born < ja.born):
            ra, rb, ja, jb = rb, ra, jb, ja
        self._parent[rb] = ra
        if jb is not None:
            assert ja is not None    # the swap above guarantees it
            ja.hops.extend(jb.hops)
            del self._journeys[rb]
        return ra

    # --------------------------------------------------------------- ingest
    def ingest(self, spans: List[Dict[str, Any]]) -> int:
        """Fold drained spans into the journey table; returns the number
        of spans that joined a journey (spans with no ids — repair,
        compaction, checkpoint — only land in the ``/trace`` ring)."""
        joined = 0
        with self._lock:
            for span in spans:
                self._recent.append(span)
                ids = span.get("spans") or ()
                if not ids:
                    continue
                root = None
                for sid in ids:
                    if sid not in self._parent:
                        self._parent[sid] = sid
                        self._born += 1
                        self._journeys[sid] = _Journey(self._born)
                    root = (self._find(sid) if root is None
                            else self._union(root, sid))
                j = self._journeys.get(root)
                if j is None:        # root survived eviction in _parent
                    self._born += 1
                    j = self._journeys[root] = _Journey(self._born)
                j.hops.append(
                    (float(span.get("t0", 0.0)),
                     float(span.get("dur", 0.0)),
                     str(span.get("name", "?"))))
                joined += 1
            self._evict_locked()
        return joined

    def _evict_locked(self) -> None:  # requires-lock: _lock
        limit = self.spec.window
        excess = len(self._journeys) - limit
        if excess <= 0:
            return
        for root, _ in sorted(self._journeys.items(),
                              key=lambda kv: kv[1].born)[:excess]:
            del self._journeys[root]
            # leave the union-find entries: a late span for an evicted
            # journey re-creates it rather than corrupting another; the
            # parent table is pruned wholesale when it outgrows the
            # window by a wide margin
        if len(self._parent) > 64 * limit:
            live = set(self._journeys)
            self._parent = {r: r for r in live}

    # --------------------------------------------------------------- report
    def recent_spans(self) -> List[Dict[str, Any]]:
        """The newest raw spans (bounded by ``trace_keep``) — the
        ``/trace`` endpoint's backing store."""
        with self._lock:
            return list(self._recent)

    def report(self) -> ProfileReport:
        """Roll the retained journeys up into a ``ProfileReport``."""
        with self._lock:
            journeys = [list(j.hops) for j in self._journeys.values()]
        service: Dict[str, List[float]] = {}
        queue: Dict[str, List[float]] = {}
        visible: List[float] = []
        complete = 0
        for hops in journeys:
            hops.sort(key=lambda h: h[0])
            names = [h[2] for h in hops]
            if "intake.draw" in names:
                end = max(t0 + dur for t0, dur, _ in hops)
                start = min(t0 for t0, dur, name in hops
                            if name == "intake.draw")
                visible.append(max(0.0, end - start))
                if "store.flush" in names:
                    complete += 1
            prev_end: Optional[float] = None
            for t0, dur, name in hops:
                service.setdefault(name, []).append(dur)
                if prev_end is not None:
                    queue.setdefault(name, []).append(
                        max(0.0, t0 - prev_end))
                prev_end = max(prev_end or t0, t0 + dur)
        report = ProfileReport(journeys=len(journeys), complete=complete)
        total = 0.0
        for name in sorted(set(service) | set(queue), key=_hop_rank):
            sv = service.get(name, [])
            qv = queue.get(name, [])
            hs = HopStats(hop=name, count=len(sv),
                          service_s=sum(sv), queue_s=sum(qv))
            if sv:
                hs.service_p50 = percentile_of(sv, 0.5)
                hs.service_p95 = percentile_of(sv, 0.95)
            if qv:
                hs.queue_p50 = percentile_of(qv, 0.5)
                hs.queue_p95 = percentile_of(qv, 0.95)
            report.hops[name] = hs
            total += hs.service_s + hs.queue_s
        if total > 0.0:
            for hs in report.hops.values():
                hs.frac = (hs.service_s + hs.queue_s) / total
        report.ranked = sorted(
            ((h, s.frac) for h, s in report.hops.items()),
            key=lambda kv: -kv[1])
        if report.ranked:
            report.bottleneck = report.ranked[0][0]
        if visible:
            report.visible_p50_s = percentile_of(visible, 0.5)
            report.visible_p95_s = percentile_of(visible, 0.95)
        return report


__all__ = ["HOP_ORDER", "HopStats", "JourneyProfiler", "ProfileReport",
           "ProfileSpec"]
