"""Seconds of each stage of a run's set-up, to standard error."""

from __future__ import annotations

import sys
import time


class Stages:
    def __init__(self, t_start: float, device):
        self.device = device
        self.last = t_start

    def mark(self, what: str) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        print(f"setup: {what}: {now - self.last:.3f} s", file=sys.stderr,
              flush=True)
        self.last = now
