"""Durable feeds: write-ahead intake log + coordinated checkpoints.

The column store survives a crash (``StoragePartition.recover()``:
manifest — any format, 1 through 3 — with lineage, zone maps, segment
levels and the layout epoch; a compaction or leveled merge commits its
rewritten manifest BEFORE queueing replaced files for GC, so the
checkpoint protocol below never cites storage state that a crash could
tear) but, before this module, the *feed* did not: adapter offsets,
in-flight holder frames, repair's event journal and the learned elastic
scale all lived in memory.  This
module is the durability half of the fix; ``core/recovery.py`` is the
restart half.  The design follows "Scalable Fault-Tolerant Data Feeds
in AsterixDB" (PAPERS.md): log the intake *before* acknowledging it,
replay at-least-once on restart, and de-duplicate at the storage
boundary (the pk-index conditional insert repair already rides), which
composes into exactly-once.  Per INGESTBASE, durability is a *compiled
property of the plan* — ``.store(durable=DurableSpec(...))`` — not
ad-hoc code in each job.

Three pieces live here (wire protocol documented in docs/DURABILITY.md):

``IntakeLog``
    Append-only segmented frame log.  Each record is a CRC-framed raw
    intake frame (the adapter's JSON-lines bytes, pre-parse) stamped
    with a monotonically increasing sequence number and the adapter's
    *resume offset after the frame*.  A torn tail (crash mid-append or
    an unsynced page) is detected by the CRC and truncated at open: the
    log's contract is that its readable prefix is exactly what was
    durably acknowledged, and anything lost past it is re-read from the
    resumable adapter at the last good record's offset.  That is why
    the default fsync policy ("interval") is safe: fsync cadence trades
    *recovery re-read volume*, never correctness.

``FrameLedger``
    The low-watermark tracker.  ``watermark()`` is the highest seq W
    such that every frame with seq <= W has been written to storage
    chunks; frames complete out of order (partition fan-out), so a done
    set above a contiguous ``low`` counter tracks the frontier.

``CheckpointStore`` / ``CheckpointJob``
    Atomic-rename checkpoint snapshots (tmp + fsync + ``os.replace`` +
    directory fsync, previous kept as ``.bak``) and the background
    thread that takes them: read W -> sync the WAL -> flush storage (so
    every row counted in W is segment-durable) -> write the checkpoint
    -> truncate sealed WAL segments <= W.  The checkpoint also carries
    the feed's soft state: repair's event journal, ref-table content
    fingerprints (recovery's lineage-trust test), and per-group
    partition counts (resume at the learned scale).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import threading
import time
import zlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

_MAGIC = b"IWL1"
_HEAD = struct.Struct("<QQI")   # seq, adapter offset after frame, len
_CRC = struct.Struct("<I")
_SEG_FMT = "wal-%020d.log"

FSYNC_POLICIES = ("always", "interval", "never")


@dataclasses.dataclass(frozen=True)
class DurableSpec:
    """Durability policy, declared on the plan (``.store(durable=...)``).

    ``fsync``: "always" fsyncs the WAL per append (smallest re-read
    window on crash), "interval" (default) fsyncs at most every
    ``fsync_interval_s`` (bounded re-read, near-zero overhead), "never"
    leaves it to the OS (checkpoints still sync explicitly).  All three
    are exactly-once — see the module docstring.
    """
    dir: str
    fsync: str = "interval"
    fsync_interval_s: float = 0.05
    checkpoint_interval_s: float = 5.0
    segment_bytes: int = 8 << 20

    def __post_init__(self):
        if not self.dir:
            raise ValueError("DurableSpec.dir is required")
        if self.fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync must be one of {FSYNC_POLICIES}, got "
                f"{self.fsync!r}")
        if self.fsync_interval_s <= 0:
            raise ValueError("fsync_interval_s must be > 0")
        if self.checkpoint_interval_s <= 0:
            raise ValueError("checkpoint_interval_s must be > 0")
        if self.segment_bytes < 1 << 12:
            raise ValueError("segment_bytes must be >= 4096")

    @property
    def wal_dir(self) -> str:
        return os.path.join(self.dir, "intake")

    @property
    def store_dir(self) -> str:
        return os.path.join(self.dir, "store")


class LogRecord(NamedTuple):
    seq: int
    offset: int          # adapter resume position AFTER this frame
    lines: List[bytes]   # the raw frame (newline-free JSON lines)


def fsync_dir(path: str) -> None:
    """Make a rename/unlink in ``path`` durable; best-effort on
    filesystems that reject directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _scan_segment(path: str, start_seq: int
                  ) -> Tuple[int, int, Optional[Tuple[int, int]]]:
    """Validate one segment's record prefix.  Returns ``(valid_bytes,
    records, last)`` where ``last`` is ``(seq, offset)`` of the final
    valid record (None if the segment holds no valid record).  Stops at
    the first torn/corrupt record — the WAL's prefix contract."""
    valid = 0
    nrec = 0
    last: Optional[Tuple[int, int]] = None
    expect = start_seq
    try:
        with open(path, "rb") as f:
            while True:
                head = f.read(4 + _HEAD.size + _CRC.size)
                if len(head) < 4 + _HEAD.size + _CRC.size:
                    break
                if head[:4] != _MAGIC:
                    break
                seq, off, ln = _HEAD.unpack_from(head, 4)
                (crc,) = _CRC.unpack_from(head, 4 + _HEAD.size)
                payload = f.read(ln)
                if len(payload) < ln:
                    break
                if zlib.crc32(head[4:4 + _HEAD.size] + payload) != crc:
                    break
                if seq != expect:
                    break
                valid = f.tell()
                nrec += 1
                last = (seq, off)
                expect = seq + 1
    except OSError:
        pass
    return valid, nrec, last


class IntakeLog:
    """Append-only segmented WAL of raw intake frames.

    Single conceptual writer (the intake thread) plus the checkpoint
    thread's ``sync()``/``truncate()`` and, under the "interval" policy,
    a background flusher thread; one lock serializes the file ops
    (the flusher moves its fsync outside it).  Segment files are named by the first sequence number they
    hold; ``truncate(upto)`` unlinks only *sealed* segments entirely
    <= ``upto`` and never the active one, so the tail record (whose
    offset is the adapter resume point) always survives.
    """

    def __init__(self, dir: str, fsync: str = "interval",
                 fsync_interval_s: float = 0.05,
                 segment_bytes: int = 8 << 20):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"bad fsync policy {fsync!r}")
        self.dir = dir
        self.fsync = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        self.segment_bytes = int(segment_bytes)
        os.makedirs(dir, exist_ok=True)
        # serializes append/rotate/sync/truncate — file I/O under it is
        # the point, like the repair/compaction step locks
        self._lock = threading.Lock()  # lock-name: wal blocking-ok
        self._f = None                 # guarded-by: _lock
        self._last_seq = 0             # guarded-by: _lock
        self._last_offset: Optional[int] = None  # guarded-by: _lock
        self._last_sync = 0.0          # guarded-by: _lock
        self.appended = 0              # single-writer stat
        self._fsync_hist = None        # obs histogram (set post-init)
        self._flush_stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        segs = self._segments()
        if segs:
            # scan the whole log for the last valid record and truncate
            # the active segment's torn tail (crash mid-append) so the
            # next append continues the valid prefix
            self._last_seq = segs[-1][0] - 1
            for start, path in segs:
                valid, nrec, last = _scan_segment(path, start)
                if last is not None:
                    self._last_seq, self._last_offset = last
                if path == segs[-1][1]:
                    try:
                        if valid < os.path.getsize(path):
                            with open(path, "r+b") as f:
                                f.truncate(valid)
                    except OSError:
                        pass
            self._f = open(segs[-1][1], "ab")
        else:
            self._open_segment_locked(1)
        if self.fsync == "interval":
            # interval syncing runs on a background flusher so the
            # intake thread never blocks on fsync (the policy already
            # tolerates an unsynced tail: recovery re-reads it from the
            # resumable adapter, see the module docstring)
            self._flusher = threading.Thread(
                target=self._flush_loop, name="wal-flusher", daemon=True)
            self._flusher.start()

    # ------------------------------------------------------------ internals
    def _segments(self) -> List[Tuple[int, str]]:
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        for n in names:
            if n.startswith("wal-") and n.endswith(".log"):
                try:
                    out.append((int(n[4:-4]), os.path.join(self.dir, n)))
                except ValueError:
                    continue
        out.sort()
        return out

    def _open_segment_locked(self, start_seq) -> None:  # requires-lock: _lock
        # (the init-time call is pre-publication: no other thread yet)
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())   # seal: sealed data is durable
            self._f.close()
        path = os.path.join(self.dir, _SEG_FMT % start_seq)
        self._f = open(path, "ab")
        fsync_dir(self.dir)

    def _flush_loop(self) -> None:
        """Interval-fsync off the intake's critical path: sample the
        active file under the lock (dup the fd so rotation/close can't
        invalidate it), fsync OUTSIDE the lock.  Syncing a dup'd fd
        covers at least everything flushed at sample time — it can only
        over-sync, never under-sync."""
        while not self._flush_stop.wait(self.fsync_interval_s):
            with self._lock:
                if self._f is None:
                    return
                self._f.flush()
                try:
                    fd = os.dup(self._f.fileno())
                except OSError:
                    continue
            t0 = time.perf_counter()
            try:
                os.fsync(fd)
            except OSError:
                pass
            finally:
                os.close(fd)
            hist = self._fsync_hist
            if hist is not None:      # outside the wal lock by design
                hist.observe(time.perf_counter() - t0)

    # ------------------------------------------------------------------ API
    def set_fsync_histogram(self, hist) -> None:
        """Route fsync latencies into an obs histogram (``wal_fsync_s``).
        Called once at feed start, before concurrent appends; the
        flusher/sync paths read the attribute without the lock."""
        self._fsync_hist = hist

    def append_frame(self, offset: int, lines: List[bytes]) -> int:
        """Log one frame; returns its sequence number.  ``offset`` is
        the adapter's resume position *after* this frame.  (Named
        ``append_frame``, not ``append``, so feedlint's duck-typed call
        resolution never confuses it with ``list.append``.)"""
        payload = b"\n".join(lines)
        fsync_dt = 0.0
        with self._lock:
            if self._f is None:
                raise RuntimeError("intake log is closed")
            if self._f.tell() >= self.segment_bytes:
                self._open_segment_locked(self._last_seq + 1)
            seq = self._last_seq + 1
            head = _HEAD.pack(seq, int(offset), len(payload))
            crc = zlib.crc32(head + payload)
            self._f.write(_MAGIC + head + _CRC.pack(crc) + payload)
            self._f.flush()
            if self.fsync == "always":
                t0 = time.perf_counter()
                os.fsync(self._f.fileno())
                fsync_dt = time.perf_counter() - t0
            self._last_seq = seq
            self._last_offset = int(offset)
            self.appended += 1
        hist = self._fsync_hist
        if fsync_dt and hist is not None:
            hist.observe(fsync_dt)
        return seq

    def sync(self) -> None:
        """fsync the active segment (checkpoints call this before
        recording a tail seq/offset, so the checkpoint never references
        a record the disk does not have)."""
        t0 = time.perf_counter()
        synced = False
        with self._lock:
            if self._f is not None:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._last_sync = time.monotonic()
                synced = True
        hist = self._fsync_hist
        if synced and hist is not None:
            hist.observe(time.perf_counter() - t0)

    def tail(self) -> Tuple[int, Optional[int]]:
        """(last logged seq, adapter offset after it).  Offset is None
        when the log holds no records (fresh, or fully truncated past a
        rotation) — the caller falls back to the checkpoint's offset."""
        with self._lock:
            return self._last_seq, self._last_offset

    def replay(self, from_seq: int) -> Iterator[LogRecord]:
        """Yield valid records with seq > ``from_seq`` in order,
        stopping at the first torn/corrupt record (prefix contract).
        Callers materialize the result before appending new frames."""
        for start, path in self._segments():
            expect = start
            try:
                f = open(path, "rb")
            except OSError:
                return
            with f:
                while True:
                    head = f.read(4 + _HEAD.size + _CRC.size)
                    if len(head) < 4 + _HEAD.size + _CRC.size:
                        break
                    if head[:4] != _MAGIC:
                        return
                    seq, off, ln = _HEAD.unpack_from(head, 4)
                    (crc,) = _CRC.unpack_from(head, 4 + _HEAD.size)
                    payload = f.read(ln)
                    if len(payload) < ln:
                        return
                    if zlib.crc32(head[4:4 + _HEAD.size]
                                  + payload) != crc:
                        return
                    if seq != expect:
                        return
                    expect = seq + 1
                    if seq > from_seq:
                        lines = payload.split(b"\n") if payload else []
                        yield LogRecord(seq, off, lines)

    def truncate(self, upto_seq: int) -> int:
        """Unlink sealed segments whose every record has seq <=
        ``upto_seq``; never the active segment.  Returns segments
        removed."""
        removed = 0
        with self._lock:
            segs = self._segments()
            for i in range(len(segs) - 1):
                if segs[i + 1][0] <= upto_seq + 1:
                    try:
                        os.unlink(segs[i][1])
                        removed += 1
                    except OSError:
                        pass
                else:
                    break
            if removed:
                fsync_dir(self.dir)
        return removed

    def close(self) -> None:
        self._flush_stop.set()
        if self._flusher is not None:
            # join BEFORE taking the lock (the loop acquires it)
            self._flusher.join(timeout=5)
        with self._lock:
            if self._f is not None:
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
                self._f.close()
                self._f = None


class FrameLedger:
    """Low-watermark tracker over WAL sequence numbers.

    ``mark_done(seqs)`` is called by the store consumer after the rows
    of those frames land in storage chunks; completions arrive out of
    order across partitions, so ``_done`` holds the frontier above the
    contiguous ``_low``.  On resume the ledger starts at the checkpoint
    watermark with the WAL tail pending, so a checkpoint can never
    claim progress past unreplayed frames.
    """

    def __init__(self, watermark: int = 0, tail_seq: int = 0,
                 tail_offset: int = 0):
        self._lock = threading.Lock()  # lock-name: wal-ledger
        self._low = int(watermark)             # guarded-by: _lock
        self._done: set = set()                # guarded-by: _lock
        self._tail_seq = max(int(tail_seq), int(watermark))  # guarded-by: _lock
        self._tail_offset = int(tail_offset)   # guarded-by: _lock

    def note_logged(self, seq: int, offset: int) -> None:
        with self._lock:
            if seq > self._tail_seq:
                self._tail_seq = seq
                self._tail_offset = int(offset)

    def mark_done(self, seqs) -> None:
        with self._lock:
            for s in seqs:
                if s > self._low:
                    self._done.add(s)
            while self._low + 1 in self._done:
                self._done.discard(self._low + 1)
                self._low += 1

    def watermark(self) -> int:
        with self._lock:
            return self._low

    def tail(self) -> Tuple[int, int]:
        with self._lock:
            return self._tail_seq, self._tail_offset

    def backlog(self) -> int:
        """Frames logged but not yet storage-complete."""
        with self._lock:
            return self._tail_seq - self._low


class CheckpointStore:
    """Atomic checkpoint snapshots: tmp + fsync + rename, previous kept
    as ``.bak`` so a crash mid-save (or a torn current file) falls back
    one checkpoint instead of losing recovery entirely."""

    FILE = "CHECKPOINT.json"

    def __init__(self, dir: str):
        self.dir = dir
        self.path = os.path.join(dir, self.FILE)

    def save(self, state: Dict) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(self.path):
            os.replace(self.path, self.path + ".bak")
        os.replace(tmp, self.path)
        fsync_dir(self.dir)

    def load(self) -> Optional[Dict]:
        for path in (self.path, self.path + ".bak"):
            try:
                with open(path) as f:
                    doc = json.load(f)
                if isinstance(doc, dict) and "watermark" in doc:
                    return doc
            except (OSError, json.JSONDecodeError):
                continue
        return None


def ref_fingerprint(table) -> str:
    """Content hash of a ref table's current snapshot (keys + value
    columns over the valid prefix).  Recovery compares checkpointed
    fingerprints against the restarted process's rebuilt tables: only
    on a match (plus a non-regressed version counter) can recovered
    lineage be trusted — otherwise every unit degrades to always-stale
    and repair re-scans, never silently-current."""
    snap = table.snapshot()
    h = hashlib.sha1()
    h.update(struct.pack("<q", int(snap.size)))
    for name in sorted(snap.arrays):
        a = np.ascontiguousarray(snap.arrays[name][:snap.size])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class DurabilityRuntime:
    """Per-feed durability state: the WAL, the ledger, the checkpoint
    store, and the background checkpoint thread.  Built fresh by
    ``FeedManager.submit`` (durable plans) or pre-initialized by
    ``core/recovery.py`` on resume."""

    def __init__(self, spec: DurableSpec, wal: IntakeLog,
                 ledger: FrameLedger, recovered: bool = False):
        self.spec = spec
        self.wal = wal
        self.ledger = ledger
        self.checkpoints = CheckpointStore(spec.dir)
        self.job: Optional[CheckpointJob] = None
        self.recovered = recovered
        # recovery stats (set by core/recovery.py before start)
        self.replayed_frames = 0
        self.replayed_records = 0
        self.replay_target_seq = 0
        self._closed = False

    @classmethod
    def create(cls, spec: DurableSpec) -> "DurabilityRuntime":
        """Fresh durable feed.  Refuses a dirty durable dir: appending
        a new feed's frames after an unrecovered log would replay them
        twice into a store this process did not recover — the caller
        wants ``FeedManager.resume`` instead."""
        ck = CheckpointStore(spec.dir)
        dirty = os.path.exists(ck.path) or os.path.exists(
            ck.path + ".bak")
        if not dirty and os.path.isdir(spec.wal_dir):
            dirty = any(n.startswith("wal-") and n.endswith(".log")
                        for n in os.listdir(spec.wal_dir))
        if dirty:
            raise RuntimeError(
                f"durable dir {spec.dir!r} already holds an intake "
                "log/checkpoint; use FeedManager.resume(plan) to "
                "recover it, or point DurableSpec.dir at a fresh "
                "directory")
        wal = IntakeLog(spec.wal_dir, spec.fsync,
                        spec.fsync_interval_s, spec.segment_bytes)
        return cls(spec, wal, FrameLedger())

    def start(self, handle, refstore, ref_tables: Tuple[str, ...]
              ) -> None:
        self.job = CheckpointJob(self, handle, refstore, ref_tables)
        self.job.start()

    def finish(self, timeout: float = 30.0) -> None:
        """Clean shutdown: stop the cadence thread, take one final
        checkpoint (the drained feed's watermark == tail, so the WAL
        truncates to just its active segment), close the WAL."""
        if self._closed:
            return
        self._closed = True
        if self.job is not None:
            self.job.finish(timeout)
        self.wal.close()

    def stop(self) -> None:
        """Abort path (join() raised): stop the thread without a final
        checkpoint — the on-disk state stays resumable as-is."""
        if self._closed:
            return
        self._closed = True
        if self.job is not None:
            self.job.stop()
        self.wal.close()


class CheckpointJob(threading.Thread):
    """Background coordinated checkpointer (one per durable feed).

    Each step: read watermark W and the WAL tail -> ``wal.sync()`` (the
    recorded tail is durable) -> ``storage.flush()`` (every row counted
    in W is segment-durable, not chunk-only) -> write the checkpoint
    atomically -> ``wal.truncate(W)``.  Steps are skipped while W has
    not advanced: soft state (repair events, scale) not captured by a
    skipped step degrades on resume to a lineage reset + full re-scan,
    which is safe (DURABILITY.md).
    """

    def __init__(self, rt: DurabilityRuntime, handle, refstore,
                 ref_tables: Tuple[str, ...]):
        super().__init__(name=f"checkpoint-{handle.cfg.name}",
                         daemon=True)
        self.rt = rt
        self.handle = handle
        self.refstore = refstore
        self.ref_tables = ref_tables
        # serializes steps (cadence vs final); long I/O under it is the
        # point, like repair-step/compaction-step
        self._step_lock = threading.Lock()  # lock-name: checkpoint-step blocking-ok
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._last_w = rt.ledger.watermark()   # guarded-by: _step_lock
        self.checkpoints = 0    # single-writer stat
        self.last_error: Optional[BaseException] = None
        self._obs = getattr(handle, "obs", None)
        self._ckpt_hist = (self._obs.registry.histogram("checkpoint_s")
                           if self._obs is not None else None)

    def run(self):
        while not self._stopped.is_set():
            self._wake.wait(self.rt.spec.checkpoint_interval_s)
            self._wake.clear()
            if self._stopped.is_set():
                return
            try:
                self.step()
            except Exception as e:   # keep checkpointing; surface last
                self.last_error = e

    def step(self, force: bool = False) -> bool:
        with self._step_lock:
            led = self.rt.ledger
            w = led.watermark()
            tail_seq, tail_off = led.tail()
            if w <= self._last_w and not force:
                return False
            t0 = time.perf_counter()
            self.rt.wal.sync()
            self.handle.storage.flush()
            self.rt.checkpoints.save(
                self._state(w, tail_seq, tail_off))
            self.rt.wal.truncate(w)
            self._last_w = w
            self.checkpoints += 1
            dur = time.perf_counter() - t0
            # under the checkpoint-step lock only (blocking-ok:
            # R6-exempt, edge declared in analysis/annotations.py)
            if self._ckpt_hist is not None:
                self._ckpt_hist.observe(dur)
            if self._obs is not None and self._obs.tracing:
                self._obs.emit("checkpoint", (), t0=time.monotonic(),
                               dur=dur, watermark=w)
            return True

    def _state(self, w: int, tail_seq: int, tail_off: int) -> Dict:
        h = self.handle
        st: Dict = {
            "format": 1,
            "feed": h.cfg.name,
            "watermark": int(w),
            "last_seq": int(tail_seq),
            "last_offset": int(tail_off),
            "partitions": {g.name: len(g.holders)
                           for g in h.stage_groups},
        }
        if h.repair is not None and self.ref_tables:
            st["repair_events"] = h.repair.snapshot_events()
            st["ref_versions"] = {
                t: self.refstore[t].version for t in self.ref_tables}
            st["ref_fingerprints"] = {
                t: ref_fingerprint(self.refstore[t])
                for t in self.ref_tables}
        return st

    def finish(self, timeout: float = 30.0) -> None:
        self._stopped.set()
        self._wake.set()
        self.join(timeout)
        self.step(force=True)

    def stop(self) -> None:
        self._stopped.set()
        self._wake.set()
        self.join(timeout=5.0)
