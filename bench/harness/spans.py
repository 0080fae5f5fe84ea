"""Arithmetic that the program-span readers share.

They read what a driver adds to its record when it gives the port's
``ServingEngine`` or ``Trainer`` a ``core.obs`` ``Tracer`` for the
window: ``spans``, the program spans and counts drained from it
(``core/obs/trace.py``), and in training the keys that a tracer adds to
each ``Trainer.step_times`` entry.  Without them every reader reads
``None``.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from bench.harness.readings import step_mean_ms


def named(run: Dict, name: str) -> List[Dict]:
    """The window's program spans called ``name``."""
    return [s for s in run.get("spans") or () if s.get("name") == name]


def device_mean_ms(run: Dict, name: str) -> Optional[float]:
    """Mean device milliseconds of the spans called ``name``."""
    vals = [s["device_s"] for s in named(run, name)]
    return statistics.fmean(vals) * 1e3 if vals else None


def traced_step_mean_ms(run: Dict, key: str) -> Optional[float]:
    """``step_mean_ms`` of a key that only a traced trainer records."""
    times = run.get("step_times") or ()
    if not times or key not in times[0]:
        return None
    return step_mean_ms(run, key)
