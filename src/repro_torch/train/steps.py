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
GSPMD step computes for its batch sharding:

  * every rank takes its rows of the global batch (``local_rows``): the
    data ranks split each microbatch, the model ranks of a data rank
    hold the same rows;
  * the state is laid out by ``train_shardings``: every leaf replicated,
    except, with ``cfg.moe_ep``, the experts, which each model rank
    holds a slice of (``moe_ep.moe_ffn_ep`` routes tokens to them).
    ``repro``'s FSDP ("embed" over "data") and dense tensor parallelism
    are memory layouts that leave the numbers as they are and are not
    ported (ROADMAP);
  * the loss is the global batch's: each rank's masked cross-entropy sum
    over the data ranks' summed mask count (a mean of per-rank means
    would weigh unequal masks wrongly), plus the balance loss averaged
    over the data ranks;
  * each rank back-propagates its share (its objective over the model
    axis's size), and the gradient of a leaf is summed over the mesh
    dimensions on which the leaf is replicated; the clipping norm sums
    each slice's squares over the dimensions that shard it.
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
from repro_torch.models.sharding import (DEFAULT_RULES, Rules, mesh_shape,
                                         sharding_ctx, tree_shardings)
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


def train_rules(cfg: ModelConfig) -> Rules:
    """The trainer's layout on a mesh: rows over the batch axes, an
    expert-parallel config's experts over "model", every other logical
    axis replicated."""
    rules: Rules = {name: None for name in DEFAULT_RULES}
    rules["batch"] = DEFAULT_RULES["batch"]
    if cfg.moe_ep:
        rules["experts"] = "model"
    return rules


def _router_whole(axes: Any, router: bool = False) -> Any:
    """The axes tree with "experts" taken off the router's leaves: every
    rank reads the router whole (``repro``'s shard_map takes it
    replicated)."""
    if isinstance(axes, dict):
        return {k: _router_whole(v, router or k == "router")
                for k, v in axes.items()}
    return tuple(None if router and a == "experts" else a for a in axes)


def train_layout_axes(cfg: ModelConfig, opt: OptConfig) -> TrainState:
    """``train_state_axes`` as the trainer lays the state out: the
    router's leaves without "experts"."""
    return _router_whole(train_state_axes(cfg, opt))


def train_shardings(cfg: ModelConfig, opt: OptConfig, mesh) -> Any:
    """The ``NamedSharding`` of every leaf of the train state on ``mesh``
    (the tree ``ckpt.restore(..., shardings=)`` takes)."""
    return tree_shardings(train_state_shapes(cfg, opt),
                          train_layout_axes(cfg, opt), mesh,
                          train_rules(cfg))


def _zip_map(fn, tree: Any, shardings: Any) -> Any:
    flat, struct = tree_flatten(tree)
    return tree_unflatten(struct, [fn(x, s) for x, s in
                                   zip(flat, tree_flatten(shardings)[0])])


def _replicated(s) -> bool:
    from torch.distributed.tensor import Replicate
    return all(isinstance(p, Replicate) for p in s.placements)


def local_state(state: Any, shardings: Any) -> Any:
    """Every leaf's slice on this rank (``to_local()`` of the leaf as a
    DTensor, cut from the whole leaf each rank holds: no collective)."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, s):
        if _replicated(s):
            return x
        return distribute_tensor(x, s.mesh, s.placements,
                                 src_data_rank=None).to_local()
    return _zip_map(one, state, shardings)


def global_state(state: Any, shardings: Any) -> Any:
    """The ranks' slices as DTensors (what ``ckpt.save`` gathers whole);
    they share the local tensors' storage."""
    from torch.distributed.tensor import DTensor
    return _zip_map(lambda x, s: DTensor.from_local(
        x, s.mesh, s.placements, run_check=False), state, shardings)


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
    microbatches) and ``update`` (the optimizer).  With ``mesh`` the
    state holds this rank's slices (``local_state``) and ``batch`` is
    the global batch."""

    def __init__(self, cfg: ModelConfig, opt: OptConfig,
                 microbatches: int = 1, mesh=None):
        self.cfg, self.opt, self.microbatches = cfg, opt, microbatches
        self.mesh = mesh
        if mesh is not None:
            sizes = mesh_shape(mesh)
            self.n_data = sizes.get("pod", 1) * sizes.get("data", 1)
            self.n_model = sizes.get("model", 1)
            self.shardings = train_shardings(cfg, opt, mesh)

    def _data_sum(self, x: Tensor) -> Tensor:
        """``x`` summed over the data ranks (in place)."""
        import torch.distributed as dist
        for a in ("pod", "data"):
            if a in self.mesh.mesh_dim_names and \
                    self.mesh.size(self.mesh.mesh_dim_names.index(a)) > 1:
                dist.all_reduce(x, group=self.mesh.get_group(a))
        return x

    def _grad(self, params: Any, batch: Dict
              ) -> Tuple[Tensor, Dict, List[Tensor]]:
        flat, struct = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            if self.mesh is None:
                loss, metrics = api.loss(self.cfg,
                                         tree_unflatten(struct, leaves),
                                         batch)
                target = loss
            else:
                loss, metrics, target = self._global_loss(
                    tree_unflatten(struct, leaves), batch)
            # a leaf cut off from the loss gets zeros, as from jax.grad
            grads = torch.autograd.grad(target, leaves, allow_unused=True,
                                        materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def _global_loss(self, params: Any, batch: Dict
                     ) -> Tuple[Tensor, Dict, Tensor]:
        """(the global batch's loss, its metrics, this rank's share to
        back-propagate) from this rank's rows."""
        with sharding_ctx(self.mesh, train_rules(self.cfg)):
            total, metrics = api.loss(self.cfg, params, batch)
        mask = batch.get("loss_mask")
        cnt = (mask.float().sum() if mask is not None else
               torch.tensor(float(batch["targets"].numel()),
                            device=total.device))
        n_all = self._data_sum(cnt.detach().clone()).clamp(min=1.0)
        ce = metrics["loss"]
        # ce is this rank's mean over max(cnt, 1); times cnt, its sum
        share = ce * cnt / n_all + (total - ce) / self.n_data
        reported = self._data_sum(torch.stack(
            [share.detach(), metrics["aux"].detach() / self.n_data]))
        out = dict(metrics, loss=reported[0], aux=reported[1],
                   tokens=n_all)
        return reported[0], out, share / self.n_model

    def _reduce(self, grads: List[Tensor]) -> List[Tensor]:
        """Each gradient summed (float32) over the mesh dimensions on
        which its leaf is replicated, one bucket a dimension."""
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate
        grads = [g.float() for g in grads]
        shards = tree_flatten(self.shardings["params"])[0]
        for dim, name in enumerate(self.mesh.mesh_dim_names):
            if self.mesh.size(dim) == 1:
                continue
            idx = [i for i, s in enumerate(shards)
                   if isinstance(s.placements[dim], Replicate)]
            if not idx:
                continue
            buf = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(buf, group=self.mesh.get_group(name))
            off = 0
            for i in idx:
                n = grads[i].numel()
                grads[i] = buf[off:off + n].view(grads[i].shape)
                off += n
        return grads

    def _grad_norm(self, grads: Any) -> Tensor:
        """The global gradient norm from this rank's slices: each leaf's
        sum of squares summed over the dimensions that shard it."""
        import torch.distributed as dist
        from torch.distributed.tensor import Shard
        shards = tree_flatten(self.shardings["params"])[0]
        groups: Dict[tuple, Tensor] = {}
        for g, s in zip(tree_flatten(grads)[0], shards):
            dims = tuple(d for d, p in enumerate(s.placements)
                         if isinstance(p, Shard) and self.mesh.size(d) > 1)
            sq = torch.sum(torch.square(g.float()))
            groups[dims] = groups[dims] + sq if dims in groups else sq
        total = None
        for dims, sq in groups.items():
            for d in dims:
                dist.all_reduce(sq, group=self.mesh.get_group(
                    self.mesh.mesh_dim_names[d]))
            total = sq if total is None else total + sq
        return torch.sqrt(total)

    def accumulate(self, params: Any, batch: Dict
                   ) -> Tuple[Tensor, Dict, Any]:
        """(loss, last microbatch's metrics, gradient tree).  With one
        microbatch the gradients keep the parameters' dtypes; with more
        they are float32 sums of each divided by the count (on a mesh,
        float32 sums over the ranks)."""
        dev = tree_flatten(params)[0][0].device
        n = self.microbatches
        if self.mesh is not None:
            batch = local_rows(batch, self.mesh, n)
        batch = batch_to(batch, dev)
        struct = tree_flatten(params)[1]
        if n == 1:
            loss, metrics, grads = self._grad(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % n:
                raise ValueError(f"batch of {b} rows does not split into "
                                 f"{n} microbatches")
            grads = None
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                mb = {k: v.reshape((n, b // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                lm, metrics, g = self._grad(params, mb)
                if grads is None:
                    grads = [torch.zeros(x.shape, dtype=torch.float32,
                                         device=dev) for x in g]
                grads = [a + x.float() / n for a, x in zip(grads, g)]
                del g
                loss = loss + lm / n
        if self.mesh is not None:
            grads = self._reduce(grads)
        return loss, metrics, tree_unflatten(struct, grads)

    def update(self, state: TrainState, loss: Tensor, metrics: Dict,
               grads: Any) -> Tuple[TrainState, Dict]:
        gnorm = None if self.mesh is None else self._grad_norm(grads)
        params, opt_state, om = adamw_update(
            self.opt, state["params"], grads, state["opt"], state["step"],
            grad_norm=gnorm)
        new_state = {"params": params, "opt": opt_state,
                     "step": state["step"] + 1}
        out = {"loss": loss, **{k: v for k, v in metrics.items()
                                if k != "loss"}, **om}
        return new_state, out

    def __call__(self, state: TrainState, batch: Dict
                 ) -> Tuple[TrainState, Dict]:
        return self.update(state, *self.accumulate(state["params"], batch))


def make_train_step(cfg: ModelConfig, opt: OptConfig,
                    microbatches: int = 1, mesh=None) -> TrainStep:
    """``repro``'s step builder: ``microbatches`` splits the per-step
    batch along dim 0 and accumulates gradients in float32; ``mesh``
    runs it as one rank of a data- and expert-parallel step."""
    return TrainStep(cfg, opt, microbatches, mesh)
