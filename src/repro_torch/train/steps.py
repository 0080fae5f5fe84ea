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
GSPMD step computes for its batch sharding, in one of two layouts
(``train_layout``):

  * **production** (every config that does not set ``moe_ep``: every
    published one, dense, ssm, vlm, encdec, moe and hybrid alike):
    ``repro``'s own layout.  Every leaf of the state is a DTensor placed
    by ``train_shardings`` under ``DEFAULT_RULES``: FSDP ("embed" over
    "data"), tensor parallelism ("heads", "ffn", "vocab", "inner",
    "ssm_heads" over "model") and expert parallelism ("experts" over
    "model", the router's included, "ffn" then replicated in the
    experts), the moments as their parameters (ZeRO), shards over a
    mesh dimension of size 1 given as replicas (``live_placements``).
    The batch is a DTensor sharded over the batch axes, built from this
    rank's rows (``local_rows``) with no scatter.  ``api.loss`` runs on
    them under ``sharding_ctx`` and ``implicit_replication`` (the plain
    tensors the models make -- positions, masks, the SSD triangle -- are
    replicas), and DTensor's propagation inserts the collectives, as
    GSPMD does: the global mask count, the balance loss over the global
    batch, MoE routing (per row on the rows' ranks, or over all tokens
    when few), the expert products on each rank's experts, the gradient
    sums (``Partial`` gradients reduced onto their leaves' placements)
    and the clipping norm come out of it;
  * **moe_ep** (a config that sets ``moe_ep``): every leaf a plain
    tensor, replicated, except the experts, which each model rank holds
    a slice of (``moe_ep.moe_ffn_ep`` routes tokens to them;
    ``local_state`` / ``global_state`` carry a whole state in and out).
    The collectives are explicit: the loss is the global batch's (each
    rank's masked cross-entropy sum over the data ranks' summed mask
    count, plus the balance loss averaged over the data ranks), each
    rank back-propagates its share (its objective over the model axis's
    size), the gradient of a leaf is summed over the mesh dimensions on
    which the leaf is replicated, and the clipping norm sums each
    slice's squares over the dimensions that shard it.  ``repro`` keeps
    a ``moe_ep`` config's other weights on ``DEFAULT_RULES``; this
    layout replicates them.
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
from repro_torch.models.sharding import (DEFAULT_RULES, Rules,
                                         allow_uneven_views, cut_to_shard,
                                         live_placements,
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


def train_layout(cfg: ModelConfig) -> str:
    """The trainer's layout on a mesh: "production" (``repro``'s
    ``DEFAULT_RULES``) for every config but one that sets ``moe_ep``,
    which trains on "moe_ep" (explicit collectives, experts over
    "model")."""
    return "moe_ep" if cfg.moe_ep else "production"


def train_rules(cfg: ModelConfig) -> Rules:
    """The rules of ``train_layout``: ``DEFAULT_RULES`` on the production
    layout; on moe_ep, rows over the batch axes, the experts over
    "model", every other logical axis replicated."""
    if train_layout(cfg) == "production":
        return dict(DEFAULT_RULES)
    rules: Rules = {name: None for name in DEFAULT_RULES}
    rules["batch"] = DEFAULT_RULES["batch"]
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
    """``train_state_axes`` as the trainer lays the state out: on moe_ep
    the router's leaves without "experts"; on the production layout
    ``repro``'s axes, the router's ("embed", "experts") included."""
    axes = train_state_axes(cfg, opt)
    return _router_whole(axes) if train_layout(cfg) == "moe_ep" else axes


def train_shardings(cfg: ModelConfig, opt: OptConfig, mesh) -> Any:
    """The ``NamedSharding`` of every leaf of the train state on ``mesh``
    (``remesh_shardings`` under ``train_rules``, with
    ``live_placements``): the placements of the trainer's DTensors, the
    tree ``ckpt.restore(..., shardings=)`` takes, and what the dry run
    prices."""
    plan = remesh_shardings(train_state_shapes(cfg, opt),
                            train_layout_axes(cfg, opt), mesh,
                            train_rules(cfg))
    return tree_map(lambda s: s._replace(
        placements=live_placements(s.placements, s.mesh)), plan)


def _zip_map(fn, tree: Any, shardings: Any) -> Any:
    flat, struct = tree_flatten(tree)
    return tree_unflatten(struct, [fn(x, s) for x, s in
                                   zip(flat, tree_flatten(shardings)[0])])


def _replicated(s) -> bool:
    from torch.distributed.tensor import Replicate
    return all(isinstance(p, Replicate) for p in s.placements)


def local_state(state: Any, shardings: Any) -> Any:
    """(moe_ep) every leaf's slice on this rank (``to_local()`` of the
    leaf as a DTensor, cut from the whole leaf each rank holds: no
    collective)."""
    def one(x, s):
        return x if _replicated(s) else cut_to_shard(x, s).to_local()
    return _zip_map(one, state, shardings)


def global_state(state: Any, shardings: Any) -> Any:
    """(moe_ep) the ranks' slices as DTensors (what ``ckpt.save``
    gathers whole); they share the local tensors' storage."""
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
    microbatches) and ``update`` (the optimizer).  ``batch`` is the
    global batch.  Without ``mesh`` the state is plain tensors.  With
    ``mesh`` the step runs ``layout`` (``train_layout``): on
    "production" the state is the DTensor tree ``train_shardings``
    places (``init_train_state(..., shardings=)``,
    ``ckpt.restore(..., shardings=)``)
    and the step takes its collectives from DTensor (``_grad_dtensor``);
    on "moe_ep" the state holds this rank's slices (``local_state``) and
    ``_global_loss``, ``_reduce``, ``_grad_norm`` and ``_data_sum`` make
    the collectives.  Metrics come back as plain tensors, the same on
    every rank."""

    def __init__(self, cfg: ModelConfig, opt: OptConfig,
                 microbatches: int = 1, mesh=None):
        self.cfg, self.opt, self.microbatches = cfg, opt, microbatches
        self.mesh = mesh
        self.layout = None
        if mesh is not None:
            sizes = mesh_shape(mesh)
            self.n_data = sizes.get("pod", 1) * sizes.get("data", 1)
            self.n_model = sizes.get("model", 1)
            self.layout = train_layout(cfg)
            self.shardings = train_shardings(cfg, opt, mesh)

    @property
    def production(self) -> bool:
        return self.layout == "production"

    def _dbatch(self, batch: Dict, dev: torch.device) -> List[Dict]:
        """(production) the microbatches of a global batch as DTensors
        sharded over the batch axes, each from this rank's rows of it
        (no scatter).  A batch of DTensors (the dry run's) is taken as
        placed and split along dim 0."""
        from torch.distributed.tensor import DTensor
        n = self.microbatches
        if all(_is_dtensor(v) for v in batch.values()):
            b = batch["tokens"].shape[0]
            with _replicas(True):
                return [{k: v.reshape((n, b // n) + tuple(v.shape[1:]))[i]
                         for k, v in batch.items()} for i in range(n)] \
                    if n > 1 else [batch]
        rows = batch_to(local_rows(batch, self.mesh, n), dev)
        rules = train_rules(self.cfg)
        out = []
        for i in range(n):
            mb = {}
            for k, v in rows.items():
                b = v.shape[0] // n
                loc = v.reshape((n, b) + tuple(v.shape[1:]))[i]
                glob = (b * self.n_data,) + tuple(v.shape[1:])
                pl = live_placements(placements(spec_for(
                    glob, ("batch",), self.mesh, rules), self.mesh),
                    self.mesh)
                mb[k] = DTensor.from_local(loc, self.mesh, pl,
                                           run_check=False)
            out.append(mb)
        return out

    def _grad_dtensor(self, params: Any, batch: Dict
                      ) -> Tuple[Tensor, Dict, List[Tensor]]:
        """(production) loss, metrics and the gradients of one
        microbatch, each gradient redistributed onto its leaf's
        placements (a ``Partial`` sum reduced there)."""
        allow_uneven_views()
        flat, struct = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        with sharding_ctx(self.mesh, train_rules(self.cfg)), \
                _replicas(True), torch.enable_grad():
            loss, metrics = api.loss(self.cfg,
                                     tree_unflatten(struct, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if g.placements != p.placements else g
                     for g, p in zip(grads, flat)]
        return (_whole(loss.detach()),
                {k: _whole(v.detach()) for k, v in metrics.items()}, grads)

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
        if self.production:
            return self._grad_dtensor(params, batch)
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
        float32 sums over the ranks; on the production layout each
        microbatch's gradient is reduced onto its leaf's placements
        before it is summed, so the sums hold those placements)."""
        dev = tree_flatten(params)[0][0].device
        n = self.microbatches
        struct = tree_flatten(params)[1]
        if self.production:
            mbs = self._dbatch(batch, dev)
        else:
            if self.mesh is not None:
                batch = local_rows(batch, self.mesh, n)
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
        if self.layout == "moe_ep":
            grads = self._reduce(grads)
        return loss, metrics, tree_unflatten(struct, grads)

    def update(self, state: TrainState, loss: Tensor, metrics: Dict,
               grads: Any) -> Tuple[TrainState, Dict]:
        gnorm = self._grad_norm(grads) if self.layout == "moe_ep" else None
        with _replicas(self.production):
            params, opt_state, om = adamw_update(
                self.opt, state["params"], grads, state["opt"],
                state["step"], grad_norm=gnorm)
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
    runs it as one rank of a mesh, on ``train_layout(cfg)``."""
    return TrainStep(cfg, opt, microbatches, mesh)
