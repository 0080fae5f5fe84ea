"""Partition holders (§6.3): bounded, partition-aligned queues that let data
frames cross job boundaries.

A **passive** holder (tail of the intake job) buffers frames and waits for
computing jobs to *pull*; an **active** holder (head of the storage job)
*pushes* received frames to its downstream consumer from its own worker
thread.  Every holder registers with a per-node ``PartitionHolderManager``
so jobs locate each other by (job, partition) — the paper's holder IDs.

Bounded capacity gives backpressure end-to-end: a slow storage job
eventually blocks the computing jobs, which stop pulling, which blocks the
intake adapter — no unbounded queue growth anywhere (the paper's "queue with
a limited size").

Extras beyond the paper, used by the runtime layer:
  * service-time EWMA + depth metrics per holder (straggler detection),
  * ``steal()`` so idle computing workers can take work from the deepest
    queue (work stealing / straggler mitigation),
  * a ``StopRecord`` sentinel implementing the paper's §7.1 drain protocol.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class StopRecord:
    """The 'special data record' of §7.1: computing jobs finish their
    current partial batch when they see it; the storage job closes after the
    last computing job."""
    __slots__ = ()

    def __repr__(self):
        return "<stop>"


STOP = StopRecord()


def frame_rows(frame: Any) -> int:
    """Rows in a frame, for backlog accounting: dict frames (pre-parsed
    struct-of-arrays) count their leading dim, byte frames their lines."""
    if isinstance(frame, dict):
        v = next(iter(frame.values()))
        return int(v.shape[0])
    try:
        return len(frame)
    except TypeError:
        return 1


def frame_bytes(frame: Any) -> int:
    if isinstance(frame, dict):
        return int(sum(v.nbytes for v in frame.values()))
    if isinstance(frame, (list, tuple)):
        return sum(len(line) for line in frame)
    return 0


class PartitionHolder:
    def __init__(self, holder_id: Tuple[str, int], capacity: int = 16):
        self.holder_id = holder_id
        self.capacity = capacity
        self._q: collections.deque = collections.deque()  # guarded-by: _lock
        self._lock = threading.Lock()       # lock-name: holder
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False                # guarded-by: _lock
        # metrics: mutated under the holder lock by producers/consumers,
        # read lock-free by stats collection after join
        self.pushed = 0                     # write-guarded-by: _lock
        self.pulled = 0                     # write-guarded-by: _lock
        self.push_wait_s = 0.0              # write-guarded-by: _lock
        self.pull_wait_s = 0.0              # write-guarded-by: _lock
        self.service_ewma_s = 0.0   # updated by consumers via record_service

    # ------------------------------------------------------------------ push
    def push(self, frame: Any, timeout: Optional[float] = None) -> bool:
        t0 = time.perf_counter()
        with self._not_full:
            while len(self._q) >= self.capacity and not self._closed:
                if not self._not_full.wait(timeout):
                    return False
            if self._closed and not isinstance(frame, StopRecord):
                raise RuntimeError(f"push to closed holder {self.holder_id}")
            self._q.append(frame)
            if isinstance(frame, StopRecord):
                # close is atomic with the STOP enqueue: a racing push must
                # RAISE (so the elastic intake/inter-group round-robin
                # re-targets it) rather than land behind the StopRecord,
                # where a retiring worker would never see it
                self._closed = True
                self._not_full.notify_all()
                self._not_empty.notify_all()
            self.pushed += 1
            self.push_wait_s += time.perf_counter() - t0
            self._not_empty.notify()
            return True

    # ------------------------------------------------------------------ pull
    def pull(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Blocks until a frame is available; returns None on timeout.
        StopRecord is re-queued so every consumer observes it."""
        t0 = time.perf_counter()
        with self._not_empty:
            while not self._q:
                if self._closed:
                    return STOP
                if not self._not_empty.wait(timeout):
                    return None
            frame = self._q.popleft()
            if isinstance(frame, StopRecord):
                self._q.appendleft(frame)   # visible to all consumers
                self._closed = True
                self._not_empty.notify_all()
                self._not_full.notify_all()
                return STOP
            self.pulled += 1
            self.pull_wait_s += time.perf_counter() - t0
            self._not_full.notify()
            return frame

    def pull_nowait(self, predicate: Optional[Callable[[Any], bool]] = None
                    ) -> Optional[Any]:
        """Non-blocking pull from the head; returns None when the queue is
        empty, the head is the StopRecord (left in place so the drain
        protocol is untouched), or ``predicate`` rejects the head frame.
        Used by the worker micro-batcher to coalesce backlogged frames."""
        with self._lock:
            if not self._q or isinstance(self._q[0], StopRecord):
                return None
            if predicate is not None and not predicate(self._q[0]):
                return None
            frame = self._q.popleft()
            self.pulled += 1
            self._not_full.notify()
            return frame

    def steal(self) -> Optional[Any]:
        """Non-blocking take from the *tail* (most recently queued) — used by
        idle workers for straggler mitigation; never steals the StopRecord."""
        with self._lock:
            # a closed holder keeps its StopRecord at the tail; steal the
            # newest real frame just before it
            for i in (-1, -2):
                if len(self._q) >= -i and not isinstance(self._q[i],
                                                         StopRecord):
                    if i == -1:
                        frame = self._q.pop()
                    else:
                        frame = self._q[i]
                        del self._q[i]
                    self.pulled += 1
                    self._not_full.notify()
                    return frame
            return None

    def close(self) -> None:
        self.push(STOP)

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def backlog(self) -> Tuple[int, int]:
        """(rows, bytes) currently queued, StopRecords excluded — the
        elasticity controller's load signal.  O(depth), and depth is
        bounded by ``capacity``, so sampling stays cheap."""
        with self._lock:
            frames = list(self._q)
        rows = nbytes = 0
        for f in frames:
            if isinstance(f, StopRecord):
                continue
            rows += frame_rows(f)
            nbytes += frame_bytes(f)
        return rows, nbytes

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def record_service(self, seconds: float, alpha: float = 0.2) -> None:
        self.service_ewma_s = (alpha * seconds
                               + (1 - alpha) * self.service_ewma_s)


class ActivePartitionHolder(PartitionHolder):
    """Push-mode holder: a worker thread drains the queue into ``consumer``.
    The storage job's head is one of these."""

    def __init__(self, holder_id: Tuple[str, int],
                 consumer: Callable[[Any], None], capacity: int = 16,
                 obs=None):
        super().__init__(holder_id, capacity)
        self._consumer = consumer
        self._obs = obs   # FeedObs for sink.append spans (None = untraced)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=f"active-holder-{holder_id}", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            frame = self.pull(timeout=0.1)
            if frame is None:
                continue
            if isinstance(frame, StopRecord):
                return
            try:
                t0 = time.perf_counter()
                self._consumer(frame)
                dt = time.perf_counter() - t0
                self.record_service(dt)
                if self._obs is not None:
                    sids = getattr(frame, "span_ids", ())
                    if sids:
                        # consumer call and span emission both run with
                        # no lock held (feedlint R3/R6 discipline)
                        self._obs.emit("sink.append", sids,
                                       t0=time.monotonic() - dt, dur=dt,
                                       sink=self.holder_id[0])
            except BaseException as e:   # surfaced by join()
                self._err = e
                # fail fast, don't deadlock: close + drain so producers
                # blocked in push() wake up (they see a closed holder)
                # instead of waiting forever on a queue nobody drains
                with self._lock:
                    self._closed = True
                    self._q.clear()
                    self._not_full.notify_all()
                    self._not_empty.notify_all()
                return

    @property
    def error(self) -> Optional[BaseException]:
        return self._err

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        if self._err is not None:
            raise self._err


class PartitionHolderManager:
    """Per-node registry: jobs look up the holders of other jobs by ID."""

    def __init__(self):
        self._holders: Dict[Tuple[str, int], PartitionHolder] = {}  # guarded-by: _lock
        self._lock = threading.Lock()       # lock-name: holder-registry

    def register(self, holder: PartitionHolder) -> PartitionHolder:
        with self._lock:
            if holder.holder_id in self._holders:
                raise KeyError(f"holder {holder.holder_id} already exists")
            self._holders[holder.holder_id] = holder
            return holder

    def lookup(self, job: str, partition: int) -> PartitionHolder:
        # feedlint R1 fix: this read used to race register/unregister
        with self._lock:
            return self._holders[(job, partition)]

    def partitions(self, job: str) -> List[PartitionHolder]:
        with self._lock:
            return [h for (j, _), h in sorted(self._holders.items())
                    if j == job]

    def deepest(self, job: str,
                exclude: Optional[int] = None) -> Optional[PartitionHolder]:
        """The most-backlogged holder of a job (work-stealing target)."""
        best, depth = None, 0
        for h in self.partitions(job):
            if exclude is not None and h.holder_id[1] == exclude:
                continue
            d = h.depth
            if d > depth:
                best, depth = h, d
        return best

    def unregister(self, holder_id: Tuple[str, int]) -> None:
        with self._lock:
            self._holders.pop(holder_id, None)
