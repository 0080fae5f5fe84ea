"""Fault-tolerant training loop fed by the IDEA pipeline, a port of
``repro.train.trainer``:

  * one step function, built once (no ``torch.compile``),
  * checkpoint every ``ckpt_every`` steps (async, atomic, keep-k),
  * on a step failure: rebuild the state from init and restore the latest
    checkpoint — bounded restarts, so optimizer steps happen exactly once,
  * loss and throughput metrics; per step, the seconds spent waiting for
    the batch, in forward + backward and in the optimizer
    (``step_times``; CUDA events on the card).

Runs on the CUDA device unless the caller passes ``device="cpu"``.
With ``mesh`` (one process a rank; ``runtime.elastic.build_mesh``) every
rank runs the same loop over the same global batches, on ``repro``'s
production layout, whatever the config: the state is the DTensor tree
of ``repro``'s production placements (FSDP over "data", tensor and
expert parallelism over "model"), drawn leaf by leaf and cut to this
rank's shards, so no rank ever holds the whole state; checkpoints
gather one leaf at a time (rank 0 writes ``repro``'s layout) and
restore onto the mesh's placements through ``remesh_shardings``, so a
checkpoint written on one mesh trains on another.  A step that fails on
one rank only is not recovered across the mesh: the others wait in its
collectives.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import (init_train_state, make_train_step,
                                     train_state_shapes)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    microbatches: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    max_restarts: int = 2
    log_every: int = 10
    seed: int = 0


class _Clock:
    """Marks on the device's timeline (CUDA events) or the host's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def spans_s(self) -> List[float]:
        """Seconds between consecutive marks (waits for the last)."""
        m = self.marks
        if self.cuda:
            m[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptConfig,
                 tcfg: TrainerConfig, device: DeviceLike = None,
                 mesh=None):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.step_fn = make_train_step(model_cfg, opt_cfg, tcfg.microbatches,
                                       mesh)
        self.ckpt = (AsyncCheckpointer(tcfg.ckpt_dir, tcfg.ckpt_keep)
                     if tcfg.ckpt_dir else None)
        self.history: List[Dict[str, float]] = []
        self.step_times: List[Dict[str, float]] = []
        self.restarts = 0
        self.state = None
        self.state = self._fresh_state()

    def _fresh_state(self):
        """The latest checkpoint's state, or without one the seed's."""
        if self.tcfg.ckpt_dir and latest_step(self.tcfg.ckpt_dir) is not None:
            return self._restore()
        return self._init_state()

    def _init_state(self):
        """The seed's state: on a mesh drawn as this rank's shards, leaf
        by leaf."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        return init_train_state(self.model_cfg, self.opt_cfg, gen,
                                self.step_fn.shardings
                                if self.mesh is not None else None)

    # ----------------------------------------------------------------- ckpt
    def _save(self, step: int) -> None:
        if self.ckpt is not None:
            self.ckpt.save(step, self.state)

    def _restore(self):
        """The latest checkpoint onto this trainer's layout: whole leaves
        on the device without a mesh; on a mesh each rank reads its
        shards of ``step_fn.shardings`` (``remesh_shardings`` of this
        mesh), as DTensors."""
        step = latest_step(self.tcfg.ckpt_dir)
        log.warning("restoring from checkpoint step %s", step)
        whole = train_state_shapes(self.model_cfg, self.opt_cfg)
        if self.mesh is None:
            return restore(self.tcfg.ckpt_dir, whole, step,
                           device=self.device)
        return restore(self.tcfg.ckpt_dir, whole, step,
                       shardings=self.step_fn.shardings)

    # ------------------------------------------------------------------ run
    def _step(self, batch: Dict, wait_s: float) -> Dict:
        clock = _Clock(self.device)
        clock.mark()
        loss, metrics, grads = self.step_fn.accumulate(
            self.state["params"], batch)
        clock.mark()
        self.state, out = self.step_fn.update(self.state, loss, metrics,
                                              grads)
        del grads
        clock.mark()
        grad_s, update_s = clock.spans_s()
        self.step_times.append({"data_wait_s": wait_s, "grad_s": grad_s,
                                "update_s": update_s})
        return out

    def run(self, batches: Iterator[Dict[str, np.ndarray]],
            fault_hook=None) -> List[Dict[str, float]]:
        """Consume ``batches`` until ``steps`` steps are done.  On failure,
        restore + resume (replaying the stream from where it stands —
        at-least-once over data, exactly-once over optimizer steps thanks
        to the step counter in the checkpoint)."""
        it = iter(batches)
        t0 = time.perf_counter()
        while int(self.state["step"]) < self.tcfg.steps:
            tw = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                log.warning("data stream ended at step %s",
                            int(self.state["step"]))
                break
            wait_s = time.perf_counter() - tw
            try:
                step_before = int(self.state["step"])
                if fault_hook is not None:
                    fault_hook(step_before)
                metrics = self._step(batch, wait_s)
                step = step_before + 1
                if step % self.tcfg.log_every == 0 or \
                        step == self.tcfg.steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    m["wall_s"] = time.perf_counter() - t0
                    self.history.append(m)
                if self.tcfg.ckpt_dir and step % self.tcfg.ckpt_every == 0:
                    self._save(step)
            except Exception:
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts or \
                        self.ckpt is None:
                    raise
                # the state may be half-updated: rebuild from checkpoint,
                # the newest one issued (a save may still be writing it)
                self.ckpt.wait()
                self.state = None
                self.state = self._fresh_state()
                log.warning("restart %d at step %s", self.restarts,
                            int(self.state["step"]))
        if self.ckpt is not None:
            self._save(int(self.state["step"]))
            self.ckpt.wait()
        return self.history
