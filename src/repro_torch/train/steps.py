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

On a device mesh (``mesh=``, a ``DeviceMesh`` with "data" and "model"
dimensions; one process a rank) the step computes what ``repro``'s
GSPMD step computes for its batch sharding, on ``repro``'s own
production layout, for every config (dense, ssm, vlm, encdec, moe and
hybrid alike, and one that sets ``moe_ep``, whose MoE layers route
their tokens by ``moe_ep.moe_ffn_ep``'s explicit hops, as ``repro``'s
``shard_map`` does, while every other leaf stays where it is).  Every
leaf of the state is a DTensor placed by ``train_shardings`` under
``DEFAULT_RULES``: FSDP ("embed" over "data"), tensor parallelism
("heads", "ffn", "vocab", "inner", "ssm_heads" over "model") and expert
parallelism ("experts" over "model", the router's included, "ffn" then
replicated in the experts), the moments as their parameters (ZeRO),
shards over a mesh dimension of size 1 given as replicas
(``live_placements``).  The batch is a DTensor sharded over the batch
axes, built from this rank's rows (``local_rows``) with no scatter.
``api.loss`` runs on them under ``sharding_ctx`` and
``implicit_replication`` (the plain tensors the models make --
positions, masks, the SSD triangle -- are replicas), and DTensor's
propagation inserts the collectives, as GSPMD does: the global mask
count, the balance loss over the global batch, MoE routing (per row on
the rows' ranks, or over all tokens when few), the expert products on
each rank's experts, the gradient sums (``Partial`` gradients reduced
onto their leaves' placements) and the clipping norm come out of it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.params import (init_leaf, params_from_numpy,
                                       tensor_to_numpy, tree_flatten,
                                       tree_map, tree_unflatten)
from repro_torch.models.sharding import (DEFAULT_RULES, allow_uneven_views,
                                         cut_to_shard, live_placements,
                                         mesh_shape, placements,
                                         sharding_ctx, spec_for)
from repro_torch.runtime.elastic import remesh_shardings
from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update,
                                         opt_state_axes)

TrainState = Dict[str, Any]        # {"params", "opt", "step"}
Tensor = torch.Tensor


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def init_train_state(cfg: ModelConfig, opt: OptConfig,
                     gen: torch.Generator, shardings: Any = None
                     ) -> TrainState:
    """Parameters drawn from ``gen`` on its device, zero moments, step 0.
    With ``shardings`` (``train_shardings`` of the production layout)
    every leaf is a DTensor of this rank's shard: each parameter is
    drawn whole, in the same order and with the same draws as without,
    cut (``cut_to_shard``) and freed before the next, and the moments
    are made as shards, so a rank holds at most one whole leaf beside
    its shards."""
    if shardings is None:
        params = api.init_params(cfg, gen)
        return {"params": params, "opt": adamw_init(opt, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=gen.device)}
    from torch.distributed.tensor import zeros

    def draw(spec, s):
        if isinstance(spec, dict):
            return {k: draw(v, s[k]) for k, v in spec.items()}
        return cut_to_shard(init_leaf(spec, gen, cfg.param_dtype), s)

    def zero(x, s):
        return zeros(tuple(x.shape), dtype=x.dtype, device_mesh=s.mesh,
                     placements=s.placements)
    shapes = train_state_shapes(cfg, opt)
    return {"params": draw(api.param_specs(cfg), shardings["params"]),
            "opt": _zip_map(zero, shapes["opt"], shardings["opt"]),
            "step": zero(shapes["step"], shardings["step"])}


def train_state_shapes(cfg: ModelConfig, opt: OptConfig) -> TrainState:
    """``meta`` tensors of the whole state (no allocation)."""
    with torch.device("meta"):
        params = api.param_shapes(cfg)
        return {"params": params, "opt": adamw_init(opt, params),
                "step": torch.zeros((), dtype=torch.int32)}


def train_state_axes(cfg: ModelConfig, opt: OptConfig) -> TrainState:
    axes = api.param_axes(cfg)
    return {"params": axes, "opt": opt_state_axes(opt, axes), "step": ()}


def train_shardings(cfg: ModelConfig, opt: OptConfig, mesh) -> Any:
    """The ``NamedSharding`` of every leaf of the train state on ``mesh``
    (``remesh_shardings`` under ``DEFAULT_RULES``, with
    ``live_placements``): the placements of the trainer's DTensors, the
    tree ``ckpt.restore(..., shardings=)`` takes, and what the dry run
    prices."""
    plan = remesh_shardings(train_state_shapes(cfg, opt),
                            train_state_axes(cfg, opt), mesh,
                            DEFAULT_RULES)
    return tree_map(lambda s: s._replace(
        placements=live_placements(s.placements, s.mesh)), plan)


def _zip_map(fn, tree: Any, shardings: Any) -> Any:
    flat, struct = tree_flatten(tree)
    return tree_unflatten(struct, [fn(x, s) for x, s in
                                   zip(flat, tree_flatten(shardings)[0])])


def local_rows(batch: Dict, mesh, microbatches: int = 1) -> Dict:
    """This rank's rows of a global batch: each of the ``microbatches``
    splits of dim 0 divided over the mesh's batch axes ("pod", "data"),
    so that local microbatch i is this rank's part of global microbatch
    i (``repro``'s split of a batch sharded over those axes)."""
    sizes = mesh_shape(mesh)
    n_d, d = 1, 0
    for a in (a for a in ("pod", "data") if a in sizes):
        n_d, d = n_d * sizes[a], d * sizes[a] + mesh.get_local_rank(a)
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % (microbatches * n_d):
            raise ValueError(f"{k}: {b} rows do not split into "
                             f"{microbatches} microbatches over {n_d} "
                             "data ranks")
        part = v.reshape((microbatches, n_d, b // (microbatches * n_d))
                         + tuple(v.shape[1:]))[:, d]
        out[k] = part.reshape((b // n_d,) + tuple(v.shape[1:]))
    return out


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
    microbatches) and ``update`` (the optimizer).  ``batch`` is the
    global batch.  Without ``mesh`` the state is plain tensors.  With
    ``mesh`` (``layout`` "production") the state is the DTensor tree
    ``train_shardings`` places (``init_train_state(..., shardings=)``,
    ``ckpt.restore(..., shardings=)``) and the step takes its
    collectives from DTensor.  Metrics come back as plain tensors, the
    same on every rank."""

    def __init__(self, cfg: ModelConfig, opt: OptConfig,
                 microbatches: int = 1, mesh=None):
        self.cfg, self.opt, self.microbatches = cfg, opt, microbatches
        self.mesh = mesh
        self.layout = None
        if mesh is not None:
            sizes = mesh_shape(mesh)
            self.n_data = sizes.get("pod", 1) * sizes.get("data", 1)
            self.layout = "production"
            self.shardings = train_shardings(cfg, opt, mesh)

    def _dbatch(self, batch: Dict, dev: torch.device) -> List[Dict]:
        """(mesh) the microbatches of a global batch as DTensors sharded
        over the batch axes, each from this rank's rows of it (no
        scatter).  A batch of DTensors (the dry run's) is taken as placed
        and split along dim 0."""
        from torch.distributed.tensor import DTensor
        n = self.microbatches
        if all(_is_dtensor(v) for v in batch.values()):
            b = batch["tokens"].shape[0]
            with _replicas(True):
                return [{k: v.reshape((n, b // n) + tuple(v.shape[1:]))[i]
                         for k, v in batch.items()} for i in range(n)] \
                    if n > 1 else [batch]
        rows = batch_to(local_rows(batch, self.mesh, n), dev)
        out = []
        for i in range(n):
            mb = {}
            for k, v in rows.items():
                b = v.shape[0] // n
                loc = v.reshape((n, b) + tuple(v.shape[1:]))[i]
                glob = (b * self.n_data,) + tuple(v.shape[1:])
                pl = live_placements(placements(spec_for(
                    glob, ("batch",), self.mesh, DEFAULT_RULES), self.mesh),
                    self.mesh)
                mb[k] = DTensor.from_local(loc, self.mesh, pl,
                                           run_check=False)
            out.append(mb)
        return out

    def _grad(self, params: Any, batch: Dict
              ) -> Tuple[Tensor, Dict, List[Tensor]]:
        """Loss, metrics and the gradients of one microbatch (a leaf cut
        off from the loss gets zeros, as from jax.grad); on a mesh each
        gradient redistributed onto its leaf's placements (a ``Partial``
        sum reduced there)."""
        flat, struct = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        if self.mesh is None:
            with torch.enable_grad():
                loss, metrics = api.loss(
                    self.cfg, tree_unflatten(struct, leaves), batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            return (loss.detach(),
                    {k: v.detach() for k, v in metrics.items()}, list(grads))
        allow_uneven_views()
        with sharding_ctx(self.mesh, DEFAULT_RULES), _replicas(True), \
                torch.enable_grad():
            loss, metrics = api.loss(self.cfg,
                                     tree_unflatten(struct, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if g.placements != p.placements else g
                     for g, p in zip(grads, flat)]
        return (_whole(loss.detach()),
                {k: _whole(v.detach()) for k, v in metrics.items()}, grads)

    def accumulate(self, params: Any, batch: Dict
                   ) -> Tuple[Tensor, Dict, Any]:
        """(loss, last microbatch's metrics, gradient tree).  With one
        microbatch the gradients keep the parameters' dtypes; with more
        they are float32 sums of each divided by the count (on a mesh
        each microbatch's gradient is reduced onto its leaf's placements
        before it is summed, so the sums hold those placements)."""
        dev = tree_flatten(params)[0][0].device
        n = self.microbatches
        struct = tree_flatten(params)[1]
        if self.mesh is not None:
            mbs = self._dbatch(batch, dev)
        else:
            batch = batch_to(batch, dev)
            b = batch["tokens"].shape[0]
            if b % n:
                raise ValueError(f"batch of {b} rows does not split into "
                                 f"{n} microbatches")
            mbs = [{k: v.reshape((n, b // n) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(n)] \
                if n > 1 else [batch]
        if n == 1:
            loss, metrics, grads = self._grad(params, mbs[0])
        else:
            grads = None
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in mbs:
                lm, metrics, g = self._grad(params, mb)
                if grads is None:
                    grads = [torch.zeros_like(x, dtype=torch.float32)
                             for x in g]
                grads = [a + x.float() / n for a, x in zip(grads, g)]
                del g
                loss = loss + lm / n
        return loss, metrics, tree_unflatten(struct, grads)

    def update(self, state: TrainState, loss: Tensor, metrics: Dict,
               grads: Any) -> Tuple[TrainState, Dict]:
        with _replicas(self.mesh is not None):
            params, opt_state, om = adamw_update(
                self.opt, state["params"], grads, state["opt"],
                state["step"])
            step = state["step"] + 1
        new_state = {"params": params, "opt": opt_state, "step": step}
        out = {"loss": loss, **{k: v for k, v in metrics.items()
                                if k != "loss"},
               **{k: _whole(v) for k, v in om.items()}}
        return new_state, out

    def __call__(self, state: TrainState, batch: Dict
                 ) -> Tuple[TrainState, Dict]:
        return self.update(state, *self.accumulate(state["params"], batch))


def _whole(x: Tensor) -> Tensor:
    """A DTensor scalar as the plain tensor every rank holds."""
    return x.full_tensor() if _is_dtensor(x) else x


def _replicas(on: bool):
    """``implicit_replication`` when ``on`` (plain tensors beside the
    production layout's DTensors are replicas)."""
    import contextlib
    if not on:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_train_step(cfg: ModelConfig, opt: OptConfig,
                    microbatches: int = 1, mesh=None) -> TrainStep:
    """``repro``'s step builder: ``microbatches`` splits the per-step
    batch along dim 0 and accumulates gradients in float32; ``mesh``
    runs it as one rank of a mesh, on the production layout."""
    return TrainStep(cfg, opt, microbatches, mesh)
