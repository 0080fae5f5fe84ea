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

The model hot paths (serving engine, train step, model layers) record
*program spans* on the same rings with ``span(name, **attrs)``, a
context manager that finds the recording tracer through one context
variable, set by ``Tracer.active(device)`` (the engine and the trainer
enter it when they are given a tracer):

* off -- no tracer active and ``torch.profiler`` not running -- a span
  costs that lookup and a check of the profiler, and touches no CUDA
  API;
* while ``torch.profiler`` runs, a span opens a function-scope
  profiler range of its name, so the device trace's host timeline
  shows it (a user-scope ``record_function`` would also lay an
  annotation over its kernels on the device timeline, which a reader of
  device busy time counts as work);
* with a tracer active, a span records ``name``, ``id``, ``parent``
  (the enclosing span's id), ``rid`` (a request id, inherited from the
  parent), its attrs, ``t0`` and ``dur`` in integer nanoseconds, and
  ``device_s``.  ``t0`` is on the device trace's clock: the profiler's
  events carry wall-clock nanoseconds, and ``now_ns`` reads
  ``perf_counter_ns`` anchored once to ``time_ns``.  On a CUDA device
  ``device_s`` comes from a CUDA event pair, resolved only in
  ``settle()``, which the caller calls where it has just synchronised
  (a device-to-host read), so tracing adds no wait of its own; on the
  CPU it is the host's seconds.  A program span reaches the rings in
  the ``settle()`` that resolves it;
* inside autograd's backward (a checkpoint's recompute) a span and a
  count record nothing, so a step records each forward span once
  whatever its rematerialisation.

``count(name, value)`` tallies a counter while a tracer is active (a
tensor's elements are summed on its device, with no read);
``settle()`` reads the counts.  Program spans and counts belong to the
thread that entered ``active``.  The feed's hop spans (``emit``) carry
monotonic seconds in ``t0``/``dur``; a program span carries nanoseconds
there, on the device trace's clock.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import json
import threading
import time
from typing import (Any, Deque, Dict, IO, Iterable, Iterator, List, Optional,
                    Tuple)

import torch

# the device trace's clock: wall-clock nanoseconds, read on perf_counter
# from one anchor so that a run's spans keep one offset from it
_WALL0_NS = time.time_ns()
_PERF0_NS = time.perf_counter_ns()


def now_ns() -> int:
    """Now on the device trace's clock (wall-clock nanoseconds)."""
    return _WALL0_NS + (time.perf_counter_ns() - _PERF0_NS)


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
        # program spans waiting for their device end, and counts; both
        # owned by the thread that entered ``active``
        self._pending: Deque[Tuple[Dict[str, Any], "_Interval"]] = \
            collections.deque()
        self._counts: Dict[str, Any] = {}

    def new_id(self) -> int:
        """Fresh span id (``next`` on a count is GIL-atomic)."""
        return next(self._ids)

    def emit(self, name: str, spans: Tuple[int, ...] = (), t0: float = 0.0,
             dur: float = 0.0, **extra: Any) -> None:
        span: Dict[str, Any] = {"name": name, "spans": list(spans),
                                "t0": t0, "dur": dur}
        if extra:
            span.update(extra)
        self._append(span)

    def _append(self, span: Dict[str, Any]) -> None:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = collections.deque(maxlen=self.capacity)
            self._tls.ring = ring
            with self._reg_lock:
                self._rings.append(ring)
        span["thread"] = threading.current_thread().name
        ring.append(span)   # deque(maxlen=...) drops-oldest, never blocks

    # ------------------------------------------------------ program spans
    @contextlib.contextmanager
    def active(self, device: Any = None) -> Iterator[None]:
        """Record this thread's program spans and counts here while the
        context is open.  On a CUDA ``device`` every span also records a
        CUDA event pair; elsewhere the host does the device's work and a
        span's device seconds are its host seconds.  Re-entering the
        tracer that is already active changes nothing."""
        cur = _SCOPE.get()
        if cur is not None and cur.tracer is self:
            yield
            return
        token = _SCOPE.set(_Scope(self, device))
        try:
            yield
        finally:
            _SCOPE.reset(token)

    def record_span(self, name: str, t0: int, dur: int,
                    **attrs: Any) -> None:
        """A host-only program span that no ``with`` encloses (a
        request's wait in a queue): ``t0`` and ``dur`` in nanoseconds on
        ``now_ns``'s clock."""
        rec = {"name": name, "id": self.new_id(), "parent": None,
               "t0": t0, "dur": dur, "device_s": None}
        rec.update(attrs)
        self._append(rec)

    def settle(self, wait: bool = False) -> List[Dict[str, Any]]:
        """Emit and return the program spans whose end the device has
        passed, with their ``device_s``, and the counts tallied since the
        last call (one record each: ``name``, ``count``, ``t0``).  Call
        it right after a read that synchronised, so that it waits for
        nothing; ``wait=True`` waits for every pending span (once the
        work is over)."""
        pend = self._pending
        out: List[Dict[str, Any]] = []
        # one stream: the ends are passed in the order they were recorded
        while pend and (wait or pend[0][1].done()):
            rec, iv = pend.popleft()
            rec["device_s"] = iv.seconds()
            self._append(rec)
            out.append(rec)
        counts, self._counts = self._counts, {}
        on_dev = {n: v for n, v in counts.items()
                  if isinstance(v, torch.Tensor)}
        if on_dev:      # one read of every device tally
            counts.update(zip(on_dev,
                              torch.stack(list(on_dev.values())).tolist()))
        t = now_ns()
        for n, v in counts.items():
            rec = {"name": n, "count": int(v), "t0": t}
            self._append(rec)
            out.append(rec)
        return out

    def _count(self, name: str, value: Any) -> None:
        if isinstance(value, torch.Tensor):
            value = value.sum(dtype=torch.int64)
        cur = self._counts.get(name)
        self._counts[name] = value if cur is None else cur + value

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


class _Interval:
    """A stretch of the device's timeline, from construction to
    ``stop()``: a CUDA event pair on the card, ``perf_counter_ns`` on the
    CPU (where the host does the device's work)."""

    __slots__ = ("_a", "_b")

    def __init__(self, cuda: bool):
        if cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._a = time.perf_counter_ns()
        self._b = None

    def stop(self) -> None:
        if isinstance(self._a, int):
            self._b = time.perf_counter_ns()
        else:
            self._b = torch.cuda.Event(enable_timing=True)
            self._b.record()

    def done(self) -> bool:
        """Whether the device has passed the end (asks, never waits)."""
        return isinstance(self._b, int) or self._b.query()

    def seconds(self) -> float:
        """Seconds from start to stop; on the card waits for the end."""
        if isinstance(self._b, int):
            return (self._b - self._a) * 1e-9
        self._b.synchronize()
        return self._a.elapsed_time(self._b) * 1e-3


class _Scope:
    """One ``Tracer.active`` context: the tracer, whether spans take
    CUDA event pairs, and the open spans (id, rid), innermost last."""

    __slots__ = ("tracer", "cuda", "stack")

    def __init__(self, tracer: Tracer, device: Any):
        self.tracer = tracer
        self.cuda = device is not None and \
            torch.device(device).type == "cuda"
        self.stack: List[Tuple[int, Any]] = []


_SCOPE: contextvars.ContextVar[Optional[_Scope]] = contextvars.ContextVar(
    "repro_torch_obs_scope", default=None)


class _Span:
    """A program span (see the module docstring).  ``t0`` is set while a
    tracer records it; ``seconds()`` reads a timed span's interval."""

    __slots__ = ("name", "rid", "attrs", "scope", "cuda", "timed", "rf",
                 "id", "parent", "t0", "interval")

    def __init__(self, name: str, rid: Any, attrs: Dict[str, Any],
                 scope: Optional[_Scope], device: Any):
        self.name, self.rid, self.attrs, self.scope = name, rid, attrs, scope
        self.cuda = (torch.device(device).type == "cuda"
                     if device is not None else scope is not None
                     and scope.cuda)
        self.timed = device is not None or scope is not None
        self.rf = None
        self.interval: Optional[_Interval] = None
        self.t0 = 0

    def __enter__(self) -> "_Span":
        if torch.autograd._profiler_enabled():
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        sc = self.scope
        if sc is not None:
            self.id = sc.tracer.new_id()
            if sc.stack:
                self.parent, prid = sc.stack[-1]
                if self.rid is None:
                    self.rid = prid
            else:
                self.parent = None
            sc.stack.append((self.id, self.rid))
            self.t0 = now_ns()
        if self.timed:
            self.interval = _Interval(self.cuda)
        return self

    def __exit__(self, *exc: Any) -> None:
        iv = self.interval
        if iv is not None:
            iv.stop()
        sc = self.scope
        if sc is not None:
            sc.stack.pop()
            rec = {"name": self.name, "id": self.id, "parent": self.parent,
                   "t0": self.t0, "dur": now_ns() - self.t0,
                   "device_s": None}
            if self.rid is not None:
                rec["rid"] = self.rid
            rec.update(self.attrs)
            sc.tracer._pending.append((rec, iv))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)

    def seconds(self) -> float:
        """The span's device seconds (waits for its end on the card)."""
        return self.interval.seconds()


_OFF = contextlib.nullcontext()


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def span(name: str, rid: Any = None, device: Any = None,
         **attrs: Any) -> Any:
    """A program span of ``name`` (a context manager; the module
    docstring says what it records).  ``device`` makes it a *timed*
    span: it measures its interval on that device even with no tracer
    active, and ``seconds()`` reads it -- the trainer's step times."""
    scope = _SCOPE.get()
    if scope is None and device is None and \
            not torch.autograd._profiler_enabled():
        return _OFF
    if device is None and _in_backward():
        return _OFF         # a checkpoint's recompute records nothing
    return _Span(name, rid, attrs, scope, device)


def count(name: str, value: Any) -> None:
    """Add ``value`` (a number, or a tensor whose elements are summed on
    its device) to counter ``name`` of the active tracer; nothing when
    none is active or in a recompute."""
    scope = _SCOPE.get()
    if scope is not None and not _in_backward():
        scope.tracer._count(name, value)


def write_jsonl(spans: Iterable[Dict[str, Any]], fp: IO[str]) -> int:
    """Serialize spans as JSON-lines; returns the number written."""
    n = 0
    for span in spans:
        fp.write(json.dumps(span, sort_keys=True) + "\n")
        n += 1
    return n


__all__ = ["TraceSpec", "Tracer", "count", "now_ns", "span", "write_jsonl"]
