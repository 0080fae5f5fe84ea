"""Versioned reference-data store (the paper's "SensitiveWords"-style
datasets that enrichment UDFs reference, and that may be UPSERTed *during*
ingestion).

The paper's Model-2 semantics: records in batch *i* must be enriched against
the reference data as of batch *i*'s pickup — intermediate UDF state (hash
tables, aggregates, top-k lists) is rebuilt at batch boundaries so upserts
are visible during ingestion.  Model 3 (stream datasource) cannot do this;
Model 1 (per record) refreshes per record but is too slow.  See §5.3.

TPU adaptation (DESIGN.md §2): a reference table is a **fixed-capacity
struct-of-arrays** with a validity count.  Upserts mutate rows in place /
append, bump a version counter, and never change array shapes — so the
AOT-compiled ("predeployed") enrichment executable keeps accepting the table
as a *parameter* across updates with zero recompilation.  This is the JAX
realization of the paper's parameterized predeployed jobs: the query is
compiled once; the batch AND the current reference snapshot are the
invocation parameters.

Tables are keyed by an int64 primary key and maintain a sorted-key index
(rebuilt lazily per snapshot) so device-side joins are `searchsorted`
probes — the sorted-reference binary-search join that replaces pointer-chase
hash tables on TPU.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import nputil

# change listener: (table name, version after the write, changed keys).
# The repair scheduler (core/repair.py) subscribes these to build its
# staleness index: dirty ref versions -> stale stored segments.
ChangeListener = Callable[[str, int, np.ndarray], None]

KEY_SENTINEL = np.iinfo(np.int64).max  # empty slot marker (sorts last)


@dataclasses.dataclass(frozen=True)
class RefSnapshot:
    """Immutable view of one table at a version.  ``arrays`` always contains
    ``key`` (int64, padded with KEY_SENTINEL) plus the value columns, each of
    the full static ``capacity`` — shape-stable across versions."""
    name: str
    version: int
    size: int                      # valid rows (<= capacity)
    arrays: Dict[str, np.ndarray]  # includes "key", sorted ascending by key

    @property
    def capacity(self) -> int:
        return int(self.arrays["key"].shape[0])


class RefTable:
    """Fixed-capacity upsertable table. Thread-safe; snapshot() is O(1) when
    unchanged and O(n log n) (re-sort) after writes.

    Snapshot builds are **double-buffered**: after a write invalidates the
    cached snapshot, the next snapshot() copies the raw columns under the
    lock (O(n) memcpy) and sorts OUTSIDE it into a fresh buffer, so an
    UPSERT/DELETE arriving mid-build never waits behind the O(n log n) sort
    and computing workers never stall a writer — the paper's adaptiveness
    requirement (reference changes visible *during* ingestion, §5.3).  A
    build raced by a write simply isn't cached: it still returns a
    consistent view as of its copy point (exactly Model-2 "state as of
    batch pickup"), and the next call rebuilds against the newer version."""

    def __init__(self, name: str, capacity: int,
                 schema: Dict[str, np.dtype]):
        self.name = name
        self.capacity = int(capacity)
        self.schema = {k: np.dtype(v) for k, v in schema.items()}
        self._lock = threading.Lock()         # lock-name: ref-table
        # readers only; never writers          # lock-name: ref-build
        self._build_lock = threading.Lock()
        self._version = 0                      # guarded-by: _lock
        self._size = 0                         # guarded-by: _lock
        self._key = np.full((capacity,), KEY_SENTINEL, np.int64)
        self._cols = {k: np.zeros((capacity,) if np.dtype(v).shape == ()
                                  else (capacity,), v)
                      for k, v in self.schema.items()}
        # column arrays may be 2-D (e.g. fixed-width token lists)
        for k, v in self.schema.items():
            if v.subdtype is not None:
                base, shape = v.subdtype
                self._cols[k] = np.zeros((capacity,) + shape, base)
        self._snapshot: Optional[RefSnapshot] = None   # guarded-by: _lock
        self._listeners: List[ChangeListener] = []  # guarded-by: _lock — listener-registry

    # -------------------------------------------------------- change events
    def add_listener(self, fn: ChangeListener) -> None:
        """Subscribe to writes: ``fn(name, version, changed_keys)`` fires
        after every upsert/delete, OUTSIDE the write lock (a listener may
        read ``version``/``snapshot`` without deadlocking).  Listeners
        must be fast and never raise — they run on the writer's thread."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: ChangeListener) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, version: int, keys: np.ndarray,  # fires-listeners
                listeners: List[ChangeListener]) -> None:
        for fn in listeners:
            fn(self.name, version, keys)

    # ------------------------------------------------------------------ DML
    def upsert(self, keys: np.ndarray, **cols: np.ndarray) -> None:
        """UPSERT semantics per the paper's footnote 1: replace the row when
        the key exists, insert otherwise.  Vectorized (this is the repair
        workload's hot write path — frequent small upserts against large
        tables): membership is one argsort + searchsorted probe instead of
        an O(table) Python dict rebuild per call; within a call the LAST
        occurrence of a duplicated key wins, as sequential replace did."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        if (keys == KEY_SENTINEL).any():
            raise ValueError("KEY_SENTINEL is reserved")
        if keys.size == 0:
            return
        with self._lock:
            uniq, last = nputil.keep_last(keys)
            cur = self._key[:self._size]
            order = np.argsort(cur, kind="stable")
            found, loc, _ = nputil.sorted_find(cur, uniq, sorter=order)
            n_new = int((~found).sum())
            if self._size + n_new > self.capacity:
                raise RuntimeError(
                    f"table {self.name} over capacity {self.capacity}")
            slots = np.empty(uniq.size, np.int64)
            slots[found] = loc[found]
            slots[~found] = np.arange(self._size, self._size + n_new)
            self._size += n_new
            self._key[slots] = uniq
            for c, arr in cols.items():
                self._cols[c][slots] = np.asarray(arr)[last]
            self._version += 1
            self._snapshot = None
            version, listeners = self._version, list(self._listeners)
        self._notify(version, keys.copy(), listeners)

    def delete(self, keys: np.ndarray) -> int:
        keys = np.unique(np.asarray(keys, np.int64).reshape(-1))
        version = removed_keys = None
        with self._lock:
            cur = self._key[:self._size]
            rm = np.isin(cur, keys)
            removed = int(rm.sum())
            if removed:
                removed_keys = cur[rm].copy()
                keep = np.where(~rm)[0]
                for c in self._cols:
                    self._cols[c][:len(keep)] = self._cols[c][keep]
                self._key[:len(keep)] = self._key[keep]
                self._key[len(keep):self._size] = KEY_SENTINEL
                self._size = len(keep)
                self._version += 1
                self._snapshot = None
                version, listeners = self._version, list(self._listeners)
        if removed:
            self._notify(version, removed_keys, listeners)
        return removed

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> RefSnapshot:
        """Sorted-by-key immutable view; cached until the next write."""
        # feedlint: allow[guarded-field] double-checked fast path: a
        # torn read is impossible (GIL-atomic ref), a stale one only
        # costs the slow path below
        snap = self._snapshot
        if snap is not None:
            return snap
        # one builder at a time: concurrent readers wait for the winner's
        # result instead of each paying the O(n log n) sort.  Writers never
        # take this lock, so upserts proceed while the build runs.
        with self._build_lock:
            # buffer 1: consistent raw copy under the write lock (memcpy)
            with self._lock:
                if self._snapshot is not None:
                    return self._snapshot
                version, size = self._version, self._size
                key = self._key.copy()
                cols = {c: arr.copy() for c, arr in self._cols.items()}
            # buffer 2: sort outside the write lock — writers proceed
            order = np.argsort(key, kind="stable")
            arrays = {"key": np.ascontiguousarray(key[order])}
            for c, arr in cols.items():
                arrays[c] = np.ascontiguousarray(arr[order])
            snap = RefSnapshot(self.name, version, size, arrays)
            with self._lock:
                # publish only if no write raced the build
                if self._version == version and self._snapshot is None:
                    self._snapshot = snap
        return snap

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def __len__(self) -> int:
        with self._lock:
            return self._size


class RefStore:
    """Named tables + a store-wide version (max of table versions) used for
    version-gated enrichment-state rebuild (beyond-paper optimization — the
    paper rebuilds every batch unconditionally)."""

    def __init__(self):
        # write-guarded: create() mutates under the lock; lookups are
        # lock-free dict reads (GIL-atomic) on the hot enrichment path
        self._tables: Dict[str, RefTable] = {}  # write-guarded-by: _lock
        self._lock = threading.Lock()           # lock-name: ref-store

    def create(self, name: str, capacity: int,
               schema: Dict[str, np.dtype]) -> RefTable:
        with self._lock:
            if name in self._tables:
                raise KeyError(f"table {name} exists")
            t = RefTable(name, capacity, schema)
            self._tables[name] = t
            return t

    def __getitem__(self, name: str) -> RefTable:
        return self._tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self._tables

    def snapshot(self, names: Tuple[str, ...]) -> Dict[str, RefSnapshot]:
        return {n: self._tables[n].snapshot() for n in names}

    def version(self, names: Tuple[str, ...]) -> Tuple[int, ...]:
        return tuple(self._tables[n].version for n in names)

    def subscribe(self, names: Tuple[str, ...],
                  fn: ChangeListener) -> None:
        for n in names:
            self._tables[n].add_listener(fn)

    def unsubscribe(self, names: Tuple[str, ...],
                    fn: ChangeListener) -> None:
        for n in names:
            if n in self._tables:
                self._tables[n].remove_listener(fn)


def refstore_from_numpy(tables: Dict[str, Dict[str, np.ndarray]]
                        ) -> RefStore:
    """A RefStore holding the given snapshot arrays: ``tables`` maps each
    table name to its columns (``key`` int64, KEY_SENTINEL-padded, plus the
    value columns, all of the table's capacity) — e.g. the ``arrays`` of
    another store's snapshots.  Capacity, dtypes and the valid rows are
    carried over, so snapshots of the new store hold the same arrays."""
    store = RefStore()
    for name, cols in tables.items():
        keys = np.asarray(cols["key"], np.int64)
        schema = {k: np.asarray(v).dtype for k, v in cols.items()
                  if k != "key"}
        t = store.create(name, int(keys.shape[0]), schema)
        ok = keys != KEY_SENTINEL
        if ok.any():
            t.upsert(keys[ok], **{k: np.asarray(cols[k])[ok]
                                  for k in schema})
    return store
