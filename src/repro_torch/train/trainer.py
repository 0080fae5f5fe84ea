"""Fault-tolerant training loop fed by the IDEA pipeline, a port of
``repro.train.trainer``:

  * one step function, built once (no ``torch.compile``),
  * checkpoint every ``ckpt_every`` steps (async, atomic, keep-k),
  * on a step failure: rebuild the state from init and restore the latest
    checkpoint — bounded restarts, so optimizer steps happen exactly once,
  * loss and throughput metrics; per step, the seconds spent waiting for
    the batch (host clock), in forward + backward and in the optimizer
    (``step_times``: ``data_wait_s``, ``grad_s``, ``update_s``; the two
    latter are timed ``core.obs`` spans, CUDA event pairs on the card).

Given a ``core.obs`` ``Tracer`` (``tracer=``), each step records the
program spans ``train.step`` with its children ``train.data_wait``,
``train.fwd_bwd`` and ``train.optimizer``, and below them the model's
(``model.attention``; ``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.combine`` and the counters ``moe.pairs_routed``,
``moe.pairs_kept``), resolved at the step's end, where the trainer waits
for the optimizer anyway.  Each ``step_times`` entry then also holds the
step's forward attention seconds (``attn_fwd_s``), its MoE routing,
dispatch and combine seconds (``moe_route_fwd_s``) and its routed and
kept (token, expert) pairs (``moe_pairs``, ``moe_pairs_kept``).

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

import contextlib
import dataclasses
import logging
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig
from repro_torch.core.obs.trace import Tracer, span
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


# the forward's MoE spans outside the expert products
_ROUTE_SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def _traced_times(records: List[Dict]) -> Dict[str, float]:
    """A step's readings from its resolved spans and counts."""
    counts = {r["name"]: r["count"] for r in records if "count" in r}
    return {
        "attn_fwd_s": sum(r["device_s"] for r in records
                          if r["name"] == "model.attention"),
        "moe_route_fwd_s": sum(r["device_s"] for r in records
                               if r["name"] in _ROUTE_SPANS),
        "moe_pairs": counts.get("moe.pairs_routed", 0),
        "moe_pairs_kept": counts.get("moe.pairs_kept", 0),
    }


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptConfig,
                 tcfg: TrainerConfig, device: DeviceLike = None,
                 mesh=None, tracer: Optional[Tracer] = None):
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
        self.tracer = tracer
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
        with span("train.fwd_bwd", device=self.device) as fwd_bwd:
            loss, metrics, grads = self.step_fn.accumulate(
                self.state["params"], batch)
        with span("train.optimizer", device=self.device) as update:
            self.state, out = self.step_fn.update(self.state, loss,
                                                  metrics, grads)
            del grads
        update_s = update.seconds()        # waits for the step's end
        times = {"data_wait_s": wait_s, "grad_s": fwd_bwd.seconds(),
                 "update_s": update_s}
        if self.tracer is not None:
            times.update(_traced_times(self.tracer.settle()))
        self.step_times.append(times)
        return out

    def _run_step(self, it: Iterator[Dict], t0: float, fault_hook) -> bool:
        """One step of ``run``: False when the stream has ended."""
        with span("train.data_wait"):
            tw = time.perf_counter()
            batch = next(it, None)
            wait_s = time.perf_counter() - tw
        if batch is None:
            log.warning("data stream ended at step %s",
                        int(self.state["step"]))
            return False
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
        return True

    def run(self, batches: Iterator[Dict[str, np.ndarray]],
            fault_hook=None) -> List[Dict[str, float]]:
        """Consume ``batches`` until ``steps`` steps are done.  On failure,
        restore + resume (replaying the stream from where it stands —
        at-least-once over data, exactly-once over optimizer steps thanks
        to the step counter in the checkpoint)."""
        it = iter(batches)
        t0 = time.perf_counter()
        with (self.tracer.active(self.device) if self.tracer is not None
              else contextlib.nullcontext()):
            while int(self.state["step"]) < self.tcfg.steps:
                with span("train.step"):
                    if not self._run_step(it, t0, fault_hook):
                        break
        if self.ckpt is not None:
            self._save(int(self.state["step"]))
            self.ckpt.wait()
        return self.history
