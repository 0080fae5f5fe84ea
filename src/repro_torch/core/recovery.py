"""Crash-restart orchestration for durable feeds (core/durability.py).

``FeedManager.resume(plan, durable_dir)`` lands here.  The restart
sequence composes exactly-once out of three at-least-once pieces:

  1. **Recover the store** — every ``StoragePartition`` rebuilds from
     its fsynced manifest (``storage.recover()``): row counts, the pk
     index, per-unit lineage, zone maps, layout epoch.  Unflushed
     chunks are gone by definition; the checkpoint protocol flushed
     storage *before* recording a watermark, so nothing counted in the
     watermark can be missing.
  2. **Replay the intake log's tail** — every WAL record with
     seq > checkpoint watermark is re-pushed through the normal
     pipeline (parse -> enrich -> store) as a pre-stamped
     ``TrackedFrame``.  Some of those rows were already stored by the
     crashed run; the store's conditional pk-index insert (the same
     machinery repair rides) skips them, so the replay is idempotent.
  3. **Fast-forward the adapter** — ``adapter.resume(offset)`` with
     the last durable record's post-frame offset; frames the crashed
     run obtained but never durably logged are re-obtained from the
     source.  This is why only resumable adapters compile with
     ``durable=`` (core/plan.py).

Soft state rides the checkpoint and is restored *only when provably
valid*: repair's ref-event journal is trusted iff the checkpointed
reference-table fingerprints match the restarted process's tables (and
versions have not regressed) — otherwise the store's lineage is reset
so every unit is always-stale and repair re-scans from scratch (never
silently-current rows).  Per-group partition counts resume the feed at
the learned elastic scale.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.durability import (CheckpointStore, DurabilityRuntime,
                                   FrameLedger, IntakeLog, LogRecord,
                                   ref_fingerprint)
from repro_torch.core.intake import Adapter, TrackedFrame
from repro_torch.core.plan import IngestPlan, Pipeline, PlanError


@dataclasses.dataclass
class RecoveryState:
    """Everything ``FeedManager._start_new`` needs to wire a resumed
    feed: the recovered durability runtime (open WAL + primed ledger),
    the replay-prefixed adapter, the learned per-group partition
    counts, the restored repair event journal (None when untrusted),
    and whether stored lineage must be reset."""
    runtime: DurabilityRuntime
    adapter: Adapter
    partitions: Dict[str, int]
    repair_events: Optional[Dict[str, List]]
    reset_lineage: bool


class _ResumeAdapter(Adapter):
    """Replay-then-live adapter: yields the WAL tail's records as
    pre-stamped ``TrackedFrame``s (the intake job logs only plain
    frames, so a replay is never re-appended), then hands over to the
    fast-forwarded inner adapter.  ``offset`` mirrors the inner
    adapter's during the live phase so new WAL records carry correct
    resume positions."""

    resumable = True

    def __init__(self, inner: Adapter, records: List[LogRecord],
                 start_offset: int):
        super().__init__()
        self.inner = inner
        self.records = records
        self.offset = int(start_offset)

    def stop(self) -> None:
        super().stop()
        self.inner.stop()

    def frames(self) -> Iterator[List[bytes]]:
        for rec in self.records:
            if self._stop.is_set():
                return
            yield TrackedFrame(rec.lines, (rec.seq,))
        for frame in self.inner.frames():
            self.offset = self.inner.offset
            yield frame


def _override_dir(plan: IngestPlan, durable_dir: str) -> IngestPlan:
    """Re-point the plan's DurableSpec (and a spill_dir that was
    derived from it) at ``durable_dir`` — resuming a directory the
    plan object did not originally name."""
    spec = plan.store_spec
    assert spec is not None and spec.durable is not None
    new_d = dataclasses.replace(spec.durable, dir=durable_dir)
    spill = spec.spill_dir
    if spill == spec.durable.store_dir:
        spill = new_d.store_dir
    new_spec = dataclasses.replace(spec, durable=new_d, spill_dir=spill)
    sinks = tuple(dataclasses.replace(s, store=new_spec) if s.is_store
                  else s for s in plan.sinks)
    return dataclasses.replace(plan, sinks=sinks)


def resume_feed(manager, plan,
                durable_dir: Optional[str] = None):
    """Recover a crashed durable feed and return its live FeedHandle
    (``FeedManager.resume`` delegates here)."""
    if isinstance(plan, Pipeline):
        plan = plan.compile(manager.refstore)
    if not isinstance(plan, IngestPlan):
        raise TypeError("resume() takes an IngestPlan or Pipeline, "
                        f"got {type(plan).__name__}")
    store_spec = plan.store_spec
    if store_spec is None or store_spec.durable is None:
        raise PlanError(
            "resume() needs a durable plan: declare "
            ".store(durable=DurableSpec(dir=...)) so there is an intake "
            "log and checkpoint to recover from")
    if durable_dir is not None:
        plan = _override_dir(plan, durable_dir)
        store_spec = plan.store_spec
    dspec = store_spec.durable

    ck = CheckpointStore(dspec.dir).load() or {}
    watermark = int(ck.get("watermark", 0))
    # open the WAL: the constructor scans every segment, truncates the
    # active segment's torn tail, and leaves the writer positioned to
    # continue the valid prefix
    wal = IntakeLog(dspec.wal_dir, dspec.fsync, dspec.fsync_interval_s,
                    dspec.segment_bytes)
    tail_seq, tail_off = wal.tail()
    tail_seq = max(tail_seq, int(ck.get("last_seq", 0)))
    if tail_off is None:
        # log holds no records (fresh dir, or fully truncated by the
        # final checkpoint of a clean shutdown): the checkpoint's
        # offset is the resume point
        tail_off = int(ck.get("last_offset", 0))
    # materialize the replay BEFORE the feed starts: the intake thread
    # appends new records to the same files a lazy reader would walk
    records = list(wal.replay(watermark))

    ledger = FrameLedger(watermark=watermark, tail_seq=tail_seq,
                         tail_offset=tail_off)
    runtime = DurabilityRuntime(dspec, wal, ledger, recovered=True)
    runtime.replayed_frames = len(records)
    runtime.replayed_records = sum(len(r.lines) for r in records)
    runtime.replay_target_seq = tail_seq

    plan.adapter.resume(tail_off)
    adapter = _ResumeAdapter(plan.adapter, records, tail_off)

    repair_events: Optional[Dict[str, List]] = None
    reset_lineage = False
    if store_spec.refresh is not None and plan.udf is not None:
        trusted = _lineage_trusted(manager.refstore,
                                   plan.udf.ref_tables, ck)
        if trusted:
            repair_events = ck.get("repair_events")
        else:
            # the reference tables this process rebuilt are not the
            # ones the stored lineage was checkpointed against (or no
            # checkpoint survived): stored versions are meaningless.
            # Degrade to a full staleness re-scan — the recovery
            # contract is "never silently-current".
            reset_lineage = True

    state = RecoveryState(
        runtime=runtime, adapter=adapter,
        partitions={str(k): int(v)
                    for k, v in (ck.get("partitions") or {}).items()},
        repair_events=repair_events, reset_lineage=reset_lineage)
    return manager.submit(plan, _resume=state)


def _lineage_trusted(refstore, tables: Tuple[str, ...],
                     ck: Dict) -> bool:
    """Recovered lineage (and the checkpointed repair journal) may be
    trusted only if every subscribed table's current content hashes to
    the checkpointed fingerprint and its version counter has not gone
    backwards — i.e. this process provably rebuilt the same reference
    state the lineage's version numbers refer to."""
    fps = ck.get("ref_fingerprints") or {}
    vs = ck.get("ref_versions") or {}
    if not fps:
        return False
    for t in tables:
        if t not in fps or t not in refstore:
            return False
        if ref_fingerprint(refstore[t]) != fps[t]:
            return False
        if refstore[t].version < int(vs.get(t, 0)):
            return False
    return True
