"""Annotation grammar and canonical lock hierarchy for feedlint (the
port's own copy of ``repro.analysis.annotations``: the same lock names,
rules and hierarchy, so the two linters judge the same code alike).

The concurrent core documents its lock discipline with lightweight,
machine-readable source annotations.  All of them are trailing comments,
so they cost nothing at runtime and survive refactors reviewably:

``# lock-name: <name>``
    On the line that creates a lock (``self._lock = threading.Lock()`` or
    a module-level ``_lock = threading.Lock()``).  Gives the lock a
    *global* name used in the acquisition-order graph.  Two locks may
    share a name when they are literally the same object passed across
    objects (e.g. the intake job borrows the feed-handle lock).  A
    ``threading.Condition(self._lock)`` is auto-detected as an alias of
    the wrapped lock and needs no annotation.

``# guarded-by: <lock-attr>``
    On the line that first assigns a field (usually in ``__init__``, or a
    module-level global).  Every read AND write of that field must happen
    inside ``with <lock>`` or in a method marked ``# requires-lock``.

``# write-guarded-by: <lock-attr>``
    Like ``guarded-by`` but only *mutations* are checked.  Used for
    single-word fields that are deliberately read lock-free (GIL-atomic
    reference reads documented in docs/CONCURRENCY.md).

``# requires-lock: <lock-attr>``
    On a ``def`` line.  The method's contract is "caller holds this
    lock"; its body is analyzed as if the lock were held, and the
    ``_locked`` suffix convention in storage.py maps onto it.

``# fires-listeners``
    On a ``def`` line.  The method invokes subscriber callbacks, so it
    must never be called while a lock is held (rule R5).

``# listener-registry``
    On a guarded field declaration holding subscriber callbacks; calling
    an element of it under a lock is an R5 violation.

``# feedlint: order <outer> -> <inner>``
    Module-level declaration of an allowed nested acquisition, unioned
    with LOCK_ORDER below (test fixtures use this form).

``# feedlint: allow[<rule>[,<rule>...]] <reason>``
    Suppress a finding on this line (or, on a ``with``/``def`` line, in
    that whole block).  Reasons are mandatory by convention and audited
    in docs/CONCURRENCY.md — e.g. storage.py flushes npz segments under
    the partition lock *deliberately* so flush+manifest stay atomic.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

#: Rule identifiers, also the tags accepted by ``feedlint: allow[...]``.
RULES: Dict[str, str] = {
    "guarded-field": "R1 guarded fields accessed only under their lock",
    "lock-order": "R2 nested lock acquisitions follow the declared order",
    "blocking-under-lock": "R3 no dispatch/device-sync/file-I/O/sleep/"
                           "queue-put under a lock",
    "epoch-fence": "R4 conditional storage writes pass expect_epoch",
    "listener-under-lock": "R5 listener callbacks fire outside locks",
    "obs-under-lock": "R6 no histogram observe / span emit under a "
                      "core lock (blocking-ok step locks exempt)",
}

#: Canonical allowed nested acquisitions, ``(outer, inner)`` by global
#: lock name.  This *is* the lock hierarchy of the core (see
#: docs/CONCURRENCY.md for the prose version).  feedlint fails on any
#: observed nesting not in the transitive closure of this list, and on
#: any cycle.
LOCK_ORDER: List[Tuple[str, str]] = [
    # RepairJob.step serializes on repair-step, then touches partitions,
    # reference tables (version probes + runner re-enrichment), its own
    # event journal, holder backlogs (feed_busy yield check) and the
    # predeploy executable cache (runner invocations).
    ("repair-step", "partition"),
    ("repair-step", "ref-table"),
    ("repair-step", "ref-build"),
    ("repair-step", "repair-events"),
    ("repair-step", "holder"),
    ("repair-step", "predeploy"),
    # CompactionJob.step: same shape — partitions + holder backlog probe.
    ("compaction-step", "partition"),
    ("compaction-step", "holder"),
    # FeedHandle.scale_up/_add_partition_locked registers the new holder
    # with the process-wide registry while holding the handle lock.
    ("handle", "holder-registry"),
    # RefTable.snapshot: the build lock admits one column-sort at a time
    # and takes the table write lock briefly at both ends.
    ("ref-build", "ref-table"),
    # CheckpointJob.step (core/durability.py) serializes on
    # checkpoint-step, then syncs the WAL, reads the ledger, flushes
    # storage partitions, and snapshots repair's event journal plus
    # reference-table fingerprints/versions for the checkpoint record.
    ("checkpoint-step", "wal"),
    ("checkpoint-step", "wal-ledger"),
    ("checkpoint-step", "partition"),
    ("checkpoint-step", "repair-events"),
    ("checkpoint-step", "ref-table"),
    ("checkpoint-step", "ref-build"),
    # Observability (core/obs): the blocking-ok step locks may observe
    # histograms (tiny per-instrument 'metrics' lock) and emit spans
    # (whose first-emit-per-thread registration takes 'trace-rings');
    # hot-path emit sites run outside strict locks (rule R6), so these
    # are the only declared inward edges.
    ("repair-step", "metrics"),
    ("repair-step", "trace-rings"),
    ("compaction-step", "metrics"),
    ("compaction-step", "trace-rings"),
    ("checkpoint-step", "metrics"),
    ("checkpoint-step", "trace-rings"),
    # No ("wal", "metrics") edge on purpose: IntakeLog times fsyncs
    # under the wal lock but observes the histogram only after release.
    # The port's hand kernels: the predeployed dispatch builds them at the
    # first use of a key on a card (repro_torch.kernels.build_all takes
    # kernel-build-all, then each source's kernel-build), and
    # RepairJob.step re-enriches through a runner under repair-step, so
    # its first step on a card may build (both locks are blocking-ok).
    ("repair-step", "kernel-build-all"),
    ("kernel-build-all", "kernel-build"),
]


def guarded_by(lock: str) -> Dict[str, Any]:
    """Annotation helper: ``x: Annotated[int, guarded_by("_lock")]``.

    The comment convention above is what the core uses (it works on
    plain assignments); this helper is the equivalent for annotated
    class-level declarations and is recognized by feedlint too.  It
    returns inert metadata — nothing at runtime reads it.
    """
    return {"guarded_by": lock}


def write_guarded_by(lock: str) -> Dict[str, Any]:
    """``Annotated`` twin of ``# write-guarded-by: <lock>``."""
    return {"write_guarded_by": lock}
