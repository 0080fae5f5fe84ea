"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``'s
raw (kineto) events: how long the device was busy, the operations that
took the most of it, the longest stretches it sat idle and what the host
was doing meanwhile, and the device time of kernels by name.

Only a short stretch of the window is traced (the drivers choose it), so
that reading the events stays quick.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Tuple

TOP = 10
MARK = "bench.traced_thread"


@dataclasses.dataclass
class Summary:
    window_s: float                    # the traced stretch, host clock
    busy_s: float                      # union of device operations
    by_name: Dict[str, float]          # device seconds by operation name
    idle_by_host: Dict[str, float]     # idle device seconds by host op

    def device_s(self, part: str) -> float:
        """Device seconds of operations whose name contains ``part``."""
        return sum(s for n, s in self.by_name.items() if part in n)

    def breakdown(self) -> Dict[str, List[Tuple[str, float]]]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


class Tracer:
    """``start()`` and ``stop()`` around the traced stretch, each at a
    point where the device has no work queued; ``finish()`` reads the
    events once the window has closed.  ``overhead_s`` is the host time
    spent inside ``start`` and ``stop``, which the drivers take out of
    the window."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.summary = None
        self.overhead_s = 0.0
        self._t0 = 0.0
        self._window = 0.0
        self._events = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        t = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        with torch.profiler.record_function(MARK):   # names this thread
            pass
        self._t0 = time.perf_counter()
        self.overhead_s += self._t0 - t

    def stop(self) -> None:
        import torch
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self._window = t - self._t0
        self.prof.__exit__(None, None, None)
        self._events = self.prof
        self.prof = None
        self.overhead_s += time.perf_counter() - t

    def finish(self) -> "Summary":
        if self._events is not None and self.summary is None:
            self.summary = summarise(
                self._events.profiler.kineto_results.events(), self._window)
            self._events = None
        return self.summary


def summarise(events, window_s: float) -> Summary:
    """The host operations that name the idle stretches are those of the
    thread that started the trace (the one that marked it ``MARK``), or
    of every thread where no mark is found."""
    events = list(events)
    thread = next((e.start_thread_id() for e in events
                   if e.name() == MARK), 0)
    dev, host = [], []
    for e in events:
        kind = str(e.device_type())
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        if kind.endswith("CUDA"):
            dev.append((start, start + dur, e.name()))
        elif kind.endswith("CPU") and thread in (0, e.start_thread_id()):
            host.append((start, start + dur, e.name()))
    by_name: Dict[str, float] = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    dev.sort()
    busy, gaps = 0, []
    cur_a = cur_b = None
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    return Summary(window_s=window_s, busy_s=busy * 1e-9, by_name=by_name,
                   idle_by_host=_idle_by_host(gaps, host))


def _idle_by_host(gaps, host) -> Dict[str, float]:
    """Each gap's seconds under the innermost operation of the tracing
    thread running at its midpoint: on one thread operations nest, so
    that is the latest started one that has not yet ended.  "python"
    where none is (the host runs Python between operations)."""
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        name = "python"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out
