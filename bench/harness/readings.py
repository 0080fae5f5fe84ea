"""Arithmetic that the step-time readers share."""

from __future__ import annotations

import statistics
from typing import Dict, Optional


def step_mean_ms(run: Dict, key: str) -> Optional[float]:
    """Mean of ``Trainer.step_times[*][key]`` over the window's steps, in
    ms, leaving out those whose data wait holds the tracer's start or
    stop (``tracer_steps``)."""
    skip = set(run.get("tracer_steps", ()))
    vals = [t[key] for i, t in enumerate(run.get("step_times", ()))
            if i not in skip]
    return statistics.fmean(vals) * 1e3 if vals else None

