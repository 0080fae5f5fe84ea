"""Train state and train step, a port of ``repro.train.steps``.

``repro`` jits one step per (model config, opt config) and scans over
microbatches inside it; the port builds one ``TrainStep`` (no
``torch.compile``) and loops over them.  Gradients are taken by autograd
with respect to detached aliases of the parameters, accumulated in
float32 divided by the microbatch count; the metrics are the last
microbatch's.  The optimizer writes the new parameters and moments into
the state's tensors, as ``repro``'s trainer donates its buffers.

``state_from_numpy`` / ``state_to_numpy`` carry a whole ``repro`` train
state ({"params", "opt": {"m", "v"}, "step"} as numpy, bfloat16 as its
2-byte words) into the port and back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.params import (params_from_numpy, tensor_to_numpy,
                                       tree_flatten, tree_map,
                                       tree_unflatten)
from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update,
                                         opt_state_axes)

TrainState = Dict[str, Any]        # {"params", "opt", "step"}
Tensor = torch.Tensor


def init_train_state(cfg: ModelConfig, opt: OptConfig,
                     gen: torch.Generator) -> TrainState:
    """Parameters drawn from ``gen`` on its device, zero moments, step 0."""
    params = api.init_params(cfg, gen)
    return {"params": params, "opt": adamw_init(opt, params),
            "step": torch.zeros((), dtype=torch.int32, device=gen.device)}


def train_state_shapes(cfg: ModelConfig, opt: OptConfig) -> TrainState:
    """``meta`` tensors of the whole state (no allocation)."""
    with torch.device("meta"):
        params = api.param_shapes(cfg)
        return {"params": params, "opt": adamw_init(opt, params),
                "step": torch.zeros((), dtype=torch.int32)}


def train_state_axes(cfg: ModelConfig, opt: OptConfig) -> TrainState:
    axes = api.param_axes(cfg)
    return {"params": axes, "opt": opt_state_axes(opt, axes), "step": ()}


def state_from_numpy(tree: Any, device: DeviceLike = None) -> TrainState:
    """A train state as numpy (``jax.tree.map(np.asarray, state)``) -> the
    port's tensors on ``device`` (None: the card), same dtypes."""
    return params_from_numpy(tree, device)


def state_to_numpy(state: TrainState) -> Any:
    """Host numpy copies of a train state (bfloat16 as 2-byte words)."""
    return tree_map(tensor_to_numpy, state)


def batch_to(batch: Dict, device: torch.device) -> Dict[str, Tensor]:
    """A batch of numpy arrays or tensors, as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


class TrainStep:
    """``step(state, batch) -> (state, metrics)``, in two halves that a
    caller may time apart: ``accumulate`` (forward and backward over the
    microbatches) and ``update`` (the optimizer)."""

    def __init__(self, cfg: ModelConfig, opt: OptConfig,
                 microbatches: int = 1):
        self.cfg, self.opt, self.microbatches = cfg, opt, microbatches

    def _grad(self, params: Any, batch: Dict
              ) -> Tuple[Tensor, Dict, List[Tensor]]:
        flat, struct = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss, metrics = api.loss(self.cfg, tree_unflatten(struct, leaves),
                                     batch)
            # a leaf cut off from the loss gets zeros, as from jax.grad
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def accumulate(self, params: Any, batch: Dict
                   ) -> Tuple[Tensor, Dict, Any]:
        """(loss, last microbatch's metrics, gradient tree).  With one
        microbatch the gradients keep the parameters' dtypes; with more
        they are float32 sums of each divided by the count."""
        dev = tree_flatten(params)[0][0].device
        batch = batch_to(batch, dev)
        struct = tree_flatten(params)[1]
        n = self.microbatches
        if n == 1:
            loss, metrics, grads = self._grad(params, batch)
            return loss, metrics, tree_unflatten(struct, grads)
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows does not split into {n} "
                             "microbatches")
        acc = None
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n):
            mb = {k: v.reshape((n, b // n) + v.shape[1:])[i]
                  for k, v in batch.items()}
            lm, metrics, grads = self._grad(params, mb)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32,
                                   device=dev) for g in grads]
            acc = [a + g.float() / n for a, g in zip(acc, grads)]
            del grads
            loss = loss + lm / n
        return loss, metrics, tree_unflatten(struct, acc)

    def update(self, state: TrainState, loss: Tensor, metrics: Dict,
               grads: Any) -> Tuple[TrainState, Dict]:
        params, opt_state, om = adamw_update(
            self.opt, state["params"], grads, state["opt"], state["step"])
        new_state = {"params": params, "opt": opt_state,
                     "step": state["step"] + 1}
        out = {"loss": loss, **{k: v for k, v in metrics.items()
                                if k != "loss"}, **om}
        return new_state, out

    def __call__(self, state: TrainState, batch: Dict
                 ) -> Tuple[TrainState, Dict]:
        return self.update(state, *self.accumulate(state["params"], batch))


def make_train_step(cfg: ModelConfig, opt: OptConfig,
                    microbatches: int = 1) -> TrainStep:
    """``repro``'s step builder: ``microbatches`` splits the per-step
    batch along dim 0 and accumulates gradients in float32."""
    return TrainStep(cfg, opt, microbatches)
