"""The intake job (§7.2): adapter -> round-robin partitioner -> passive
intake partition holders.

Adapters obtain/receive raw data and arrange it into frames (one frame = one
computing batch of JSON-line byte records).  The intake job never parses in
the new framework — parsing happens inside the (parallel) computing jobs,
which is exactly the difference the paper measures against "current feeds"
where a single intake node parses everything (Fig 24's bottleneck).

Durable feeds (core/durability.py) add a resumable-offset contract to the
adapter: ``offset`` is the position from which a restarted feed can
re-obtain everything after the frames already yielded, ``resume(offset)``
fast-forwards a fresh adapter to that position, and adapters that cannot
replay lost input (a live socket) declare ``resumable = False`` /
raise ``NotResumableError`` so plan compilation rejects ``durable=`` on
them up front.  When a WAL is attached, ``IntakeJob`` appends every live
frame to it *before* the first push (write-ahead ack) and stamps the
frame with its log sequence number, which rides to the store sink and
drives the checkpoint watermark.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.partition_holder import PartitionHolder
from repro_torch.core.records import SyntheticTweets, batch_rows


class NotResumableError(RuntimeError):
    """The adapter cannot re-obtain past input from an offset (so a
    durable plan over it cannot guarantee zero loss across a crash)."""


class TrackedFrame(list):
    """A raw frame carrying the WAL sequence number(s) of the intake-log
    record(s) it covers.  A plain ``list`` subclass so every downstream
    consumer (parser, coalescing, ``len``) treats it as the frame it is;
    the ``wal_seqs`` stamp rides through the worker to the store sink,
    where completion marks the ledger.  Replayed frames are built as
    TrackedFrames by recovery — the intake job logs only plain frames,
    so a replay is never re-appended to the WAL.

    The observability layer (core/obs) rides the same vehicle:
    ``span_ids`` are the trace span ids stamped at intake (coalescing
    unions them), and ``t_intake`` is the monotonic intake timestamp
    that store-visible latency (``ingest_visible_latency_s``) is
    measured from.  Both default empty/0 so WAL- and recovery-built
    frames are unchanged."""

    __slots__ = ("wal_seqs", "span_ids", "t_intake")

    def __init__(self, lines, wal_seqs: Tuple[int, ...] = (),
                 span_ids: Tuple[int, ...] = (), t_intake: float = 0.0):
        super().__init__(lines)
        self.wal_seqs = tuple(wal_seqs)
        self.span_ids = tuple(span_ids)
        self.t_intake = t_intake


class TrackedBatch(dict):
    """The columnar counterpart of ``TrackedFrame``: a pre-parsed batch
    (plain column dict) carrying the same stamps.  A ``dict`` subclass,
    so every consumer that branches on ``isinstance(frame, dict)`` —
    the parser's pre-parsed path, coalescing, row counting — treats it
    as the batch it is, while ``getattr(frame, "span_ids", ...)`` lifts
    the stamps exactly like it does off a TrackedFrame.

    Two producers build these: the intake job (dict frames from
    pre-parsed adapters) and ``FeedHandle._push_downstream`` (enriched
    batches crossing a stage-group boundary), which is what makes
    multi-group plans keep WAL seqs, span ids, and the intake timestamp
    end to end instead of dropping them at the intermediate holder
    hand-off."""

    __slots__ = ("wal_seqs", "span_ids", "t_intake")

    def __init__(self, batch, wal_seqs: Optional[Tuple[int, ...]] = None,
                 span_ids: Tuple[int, ...] = (), t_intake: float = 0.0):
        super().__init__(batch)
        self.wal_seqs = tuple(wal_seqs) if wal_seqs else None
        self.span_ids = tuple(span_ids)
        self.t_intake = t_intake


class Adapter:
    """Iterator of frames (list[bytes]); ``stop()`` requests early end.

    Resumable-offset contract: ``frames()`` keeps ``self.offset`` equal
    to the resume position *after* the most recently yielded frame (the
    unit is adapter-defined: bytes for files, records for the synthetic
    stream).  ``resume(offset)`` positions a fresh instance so its
    ``frames()`` yields exactly the post-``offset`` remainder; the base
    class declines (``resumable = False``)."""

    resumable = False

    def __init__(self):
        self._stop = threading.Event()
        self.offset = 0   # resume position after the last yielded frame

    def stop(self) -> None:
        self._stop.set()

    def resume(self, offset: int) -> None:
        raise NotResumableError(
            f"{type(self).__name__} cannot resume from an offset")

    def frames(self) -> Iterator[List[bytes]]:
        raise NotImplementedError


class SyntheticAdapter(Adapter):
    """Deterministic tweet stream: ``total`` records in ``frame_size``
    frames, optionally rate-limited (records/second).  Offset = records
    emitted; ``resume(n)`` regenerates and discards the first ``n``
    records (the stream is seed-deterministic, so the remainder is
    bitwise the one a crashed feed would have produced)."""

    resumable = True

    def __init__(self, total: int, frame_size: int, seed: int = 0,
                 rate: Optional[float] = None):
        super().__init__()
        self.total, self.frame_size, self.rate = total, frame_size, rate
        self.source = SyntheticTweets(seed=seed)
        self._resume_at = 0

    def resume(self, offset: int) -> None:
        offset = int(offset)
        if not 0 <= offset <= self.total:
            raise ValueError(
                f"resume offset {offset} outside [0, {self.total}]")
        self._resume_at = offset
        self.offset = offset

    def frames(self) -> Iterator[List[bytes]]:
        # Fast-forward by replaying EXACTLY the chunked draws the
        # original run made: raw_lines interleaves vectorized rng draws
        # sized by the call with per-record draws, so any other chunking
        # desyncs the stream.  A mid-frame offset lands inside one
        # original frame_size chunk — regenerate that chunk whole and
        # emit its unseen suffix as a short first frame.
        drawn = 0
        first: List[bytes] = []
        while drawn < self._resume_at:
            n = min(self.frame_size, self.total - drawn)
            chunk = self.source.raw_lines(n)
            rest = self._resume_at - drawn
            if rest < n:
                first = chunk[rest:]
            drawn += n

        def gen() -> Iterator[List[bytes]]:
            if first:
                yield first
            yield from self.source.batches(self.total - drawn,
                                           self.frame_size)

        t0 = time.perf_counter()
        sent = 0
        for frame in gen():
            if self._stop.is_set():
                return
            if self.rate:
                target = t0 + sent / self.rate
                delay = target - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            sent += len(frame)
            self.offset = self._resume_at + sent
            yield frame


class FileAdapter(Adapter):
    """JSON-lines file -> frames.  Offset = byte position after the last
    line of the last yielded frame; ``resume(offset)`` seeks."""

    resumable = True

    def __init__(self, path: str, frame_size: int):
        super().__init__()
        self.path, self.frame_size = path, frame_size
        self._resume_at = 0

    def resume(self, offset: int) -> None:
        offset = int(offset)
        if offset < 0:
            raise ValueError(f"resume offset {offset} < 0")
        self._resume_at = offset
        self.offset = offset

    def frames(self) -> Iterator[List[bytes]]:
        buf: List[bytes] = []
        # manual readline loop (not ``for line in f``): the read-ahead
        # iterator would desync f.tell() from the consumed position,
        # and the offset contract needs the exact byte after the frame
        with open(self.path, "rb") as f:
            if self._resume_at:
                f.seek(self._resume_at)
            self.offset = f.tell()
            while True:
                line = f.readline()
                if not line:
                    break
                if self._stop.is_set():
                    return
                stripped = line.strip()
                if stripped:
                    buf.append(stripped)
                if len(buf) >= self.frame_size:
                    self.offset = f.tell()
                    yield buf
                    buf = []
            if buf:
                self.offset = f.tell()
                yield buf


class SocketAdapter(Adapter):
    """The paper's socket feed (Fig 4): newline-delimited JSON over TCP.
    Listens on (host, port); one connection at a time; EOF ends the feed.

    Explicitly not resumable: bytes a crashed feed failed to log are
    gone from a live socket, so ``durable=`` on this adapter is a
    compile-time ``PlanError`` (the upstream must re-send, e.g. via a
    file spool or a seekable broker) rather than a restart-time
    surprise."""

    resumable = False

    def __init__(self, host: str, port: int, frame_size: int):
        super().__init__()
        self.host, self.port, self.frame_size = host, port, frame_size
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.5)

    @property
    def address(self):
        return self._srv.getsockname()

    def resume(self, offset: int) -> None:
        raise NotResumableError(
            "SocketAdapter cannot replay lost socket input from an "
            "offset; spool the stream to a file (FileAdapter) for "
            "durable ingestion")

    def frames(self) -> Iterator[List[bytes]]:
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._srv.accept()
                    break
                except socket.timeout:
                    continue
            else:
                return
            buf: List[bytes] = []
            with conn, conn.makefile("rb") as f:
                for line in f:
                    if self._stop.is_set():
                        return
                    line = line.strip()
                    if not line:
                        continue
                    buf.append(line)
                    if len(buf) >= self.frame_size:
                        yield buf
                        buf = []
            if buf:
                yield buf
        finally:
            self._srv.close()


class IntakeJob(threading.Thread):
    """Long-running intake: distributes frames round-robin over the intake
    partition holders, then closes them (StopRecord drain, §7.1).

    ``holders`` is a live list — the elastic runtime appends (scale_up) and
    removes (scale_down) holders mid-feed under the feed handle's ``lock``;
    the round-robin partitioner re-targets automatically.  A push that
    lands on a holder retired between the snapshot and the push (it drained
    and closed) is retried against a fresh snapshot, so scale_down can
    never drop a frame.  On completion the intake flips ``closing`` under
    the lock *before* closing the holders — ``scale_up`` checks it under
    the same lock, so a late scale-up can never add a holder that would
    miss its StopRecord.

    With a WAL attached (durable plans), every *live* frame is appended
    to the log — together with the adapter's post-frame resume offset —
    before the first push attempt, and the frame is stamped with the
    record's sequence number.  Replayed frames (already ``TrackedFrame``)
    pass through unlogged.
    """

    def __init__(self, adapter: Adapter, holders: List[PartitionHolder],
                 lock: Optional[threading.Lock] = None,
                 wal=None, ledger=None, obs=None):
        super().__init__(name="intake-job", daemon=True)
        self.adapter = adapter
        self.holders = holders
        self.frames_in = 0
        self.records_in = 0
        self.closing = False     # guarded-by: _lock
        self.error: Optional[BaseException] = None
        self._wal = wal
        self._ledger = ledger
        self._obs = obs          # FeedObs (None for bare/test intakes)
        self._wal_hist = (obs.registry.histogram("wal_append_s")
                          if obs is not None and wal is not None else None)
        # the decoupled path passes the feed-handle lock in, so
        # scale_up's closing check and the drain flip serialize on
        # the SAME lock; the coupled baseline gets a private one
        self._lock = lock or threading.Lock()   # lock-name: handle

    def run(self) -> None:
        try:
            i = 0
            t_last = time.perf_counter()
            for frame in self.adapter.frames():
                draw_s = time.perf_counter() - t_last
                wal_s = None
                if self._wal is not None and not isinstance(
                        frame, (TrackedFrame, dict)):
                    # write-ahead ack: log before any holder sees it
                    off = getattr(self.adapter, "offset", 0)
                    t_wal = time.perf_counter()
                    seq = self._wal.append_frame(off, frame)
                    wal_s = time.perf_counter() - t_wal
                    self._ledger.note_logged(seq, off)
                    frame = TrackedFrame(frame, (seq,))
                if self._obs is not None:
                    # currency stamp (always) + span ids (tracing only);
                    # no lock is held here (feedlint R6 discipline).
                    # Pre-parsed dict frames ride a TrackedBatch, raw
                    # line frames a TrackedFrame — same stamps either way
                    if isinstance(frame, dict):
                        if not isinstance(frame, TrackedBatch):
                            frame = TrackedBatch(frame)
                        nrows = batch_rows(frame)
                    else:
                        if not isinstance(frame, TrackedFrame):
                            frame = TrackedFrame(frame)
                        nrows = len(frame)
                    frame.t_intake = time.monotonic()
                    if wal_s is not None:
                        self._wal_hist.observe(wal_s)
                    if self._obs.tracing:
                        frame.span_ids = (self._obs.new_span(),)
                        self._obs.emit("intake.draw", frame.span_ids,
                                       t0=frame.t_intake, dur=draw_s,
                                       rows=nrows)
                        if wal_s is not None:
                            self._obs.emit("wal.append", frame.span_ids,
                                           t0=frame.t_intake, dur=wal_s,
                                           rows=nrows)
                while True:
                    # snapshot the live holder list each frame (elasticity)
                    hs = list(self.holders)
                    target = hs[i % len(hs)]
                    try:
                        target.push(frame)
                        break
                    except RuntimeError:
                        if not target.closed:
                            raise
                        # holder retired mid-push: re-target round-robin
                i += 1
                self.frames_in += 1
                # dict frames arrive pre-parsed; len() would count COLUMNS
                self.records_in += (batch_rows(frame)
                                    if isinstance(frame, dict)
                                    else len(frame))
                t_last = time.perf_counter()
        except BaseException as e:
            self.error = e
        finally:
            with self._lock:
                self.closing = True
                hs = list(self.holders)
            for h in hs:                 # close OUTSIDE the lock: push of
                if not h.closed:         # the StopRecord may block briefly
                    h.close()
