"""Batch trace spans: a low-overhead, lock-free-per-thread ring tracer.

Every pipeline hop that touches a tracked batch emits one *span* — a
small dict with a name from the taxonomy in docs/OBSERVABILITY.md
(``intake.draw``, ``wal.append``, ``coalesce``, ``apply.<group>``,
``sink.append``, ``store.append``, ``store.flush``, ``repair.unit``,
``compact.merge``, ``checkpoint``), the frame's span ids, a monotonic
start time, and a duration.  Span ids ride the frame intake→worker→store
on ``TrackedFrame``/``_StoreBatch`` exactly like ``wal_seqs`` do,
so one batch's whole journey reconstructs from the drained spans.

Design for the hot path (the bench-smoke overhead gate holds the traced
feed to >= 0.97x untraced throughput):

* each emitting thread appends to its **own** ``collections.deque`` with
  ``maxlen`` — appends never take a lock, and a full ring drops its
  oldest span instead of blocking (deque semantics);
* the only lock (``trace-rings``) guards the ring *registry* and is
  taken once per thread's first emit plus once per ``drain()``;
* span ids come from ``itertools.count`` — ``next()`` is atomic under
  the GIL.

``drain()`` (via ``FeedHandle.drain_trace()``) empties every ring and
returns spans sorted by start time; ``TraceSpec(path=...)`` makes
``join()`` write them as JSON-lines for offline waterfall analysis.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import threading
from typing import Any, Deque, Dict, IO, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Per-plan tracing policy (``.options(trace=...)``).

    ``capacity`` bounds each thread's ring (oldest spans drop when the
    consumer falls behind — tracing never applies backpressure);
    ``path`` if set makes ``FeedHandle.join()`` dump the remaining spans
    as JSON-lines there."""
    capacity: int = 4096
    path: Optional[str] = None

    def __post_init__(self):
        if self.capacity <= 0:
            raise ValueError("trace capacity must be > 0")


class Tracer:
    """Per-thread ring-buffer span collector.  ``emit`` is lock-free on
    the hot path; ``drain`` is the single consumer."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("trace capacity must be > 0")
        self.capacity = capacity
        # registration-only lock: taken once per thread's first emit and
        # once per drain — never on the per-span hot path
        self._reg_lock = threading.Lock()  # lock-name: trace-rings
        self._rings: List[Deque[Dict[str, Any]]] = []  # guarded-by: _reg_lock
        self._tls = threading.local()
        self._ids = itertools.count(1)

    def new_id(self) -> int:
        """Fresh span id (``next`` on a count is GIL-atomic)."""
        return next(self._ids)

    def emit(self, name: str, spans: Tuple[int, ...] = (), t0: float = 0.0,
             dur: float = 0.0, **extra: Any) -> None:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = collections.deque(maxlen=self.capacity)
            self._tls.ring = ring
            with self._reg_lock:
                self._rings.append(ring)
        span: Dict[str, Any] = {"name": name, "spans": list(spans),
                                "t0": t0, "dur": dur,
                                "thread": threading.current_thread().name}
        if extra:
            span.update(extra)
        ring.append(span)   # deque(maxlen=...) drops-oldest, never blocks

    def drain(self) -> List[Dict[str, Any]]:
        """Empty every thread's ring; spans come back sorted by start
        time.  Safe against concurrent emitters: ``popleft`` and
        ``append`` on a deque are independently thread-safe, so a race
        only means a just-emitted span waits for the next drain."""
        with self._reg_lock:
            rings = list(self._rings)
        out: List[Dict[str, Any]] = []
        for ring in rings:
            while True:
                try:
                    out.append(ring.popleft())
                except IndexError:
                    break
        out.sort(key=lambda s: s.get("t0", 0.0))
        return out


def write_jsonl(spans: Iterable[Dict[str, Any]], fp: IO[str]) -> int:
    """Serialize spans as JSON-lines; returns the number written."""
    n = 0
    for span in spans:
        fp.write(json.dumps(span, sort_keys=True) + "\n")
        n += 1
    return n


__all__ = ["TraceSpec", "Tracer", "write_jsonl"]
