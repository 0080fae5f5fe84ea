"""Shared vectorized membership idioms.

The storage pk index (storage.py ``_PkIndex``) and the versioned ref
tables (refdata.py ``RefTable.upsert``) both replace per-row Python loops
with the same two primitives; keeping them here means a boundary/dtype
fix lands in both at once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def keep_last(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate ``ids`` keeping each value's LAST occurrence (matching
    sequential replace semantics: later rows supersede earlier).  Returns
    ``(unique_values_sorted, last_occurrence_positions)`` — index ``ids``
    (or a parallel payload array) with the positions."""
    uniq, rev_first = np.unique(ids[::-1], return_index=True)
    return uniq, ids.shape[0] - 1 - rev_first


def sorted_find(values: np.ndarray, needles: np.ndarray,
                sorter: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized membership probe of ``needles`` against ``values``
    (sorted ascending, or unsorted with an argsort ``sorter``).  Returns
    ``(found_mask, locations, insert_pos)``: ``locations`` indexes into
    ``values`` for each found needle (undefined where not found);
    ``insert_pos`` is the searchsorted insertion point (for merge-inserts
    into the sorted layout — only meaningful without ``sorter``)."""
    n = int(values.shape[0])
    pos = np.searchsorted(values, needles, sorter=sorter)
    if n == 0:
        return np.zeros(needles.shape[0], bool), pos, pos
    clamped = np.minimum(pos, n - 1)
    loc = clamped if sorter is None else sorter[clamped]
    found = (pos < n) & (values[loc] == needles)
    return found, loc, pos
