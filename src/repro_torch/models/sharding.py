"""Logical-axis sharding rules over ``torch.distributed`` device meshes, a
port of ``repro.models.sharding``.

Model code annotates parameters and activations with *logical* axis names
("embed", "heads", "ffn", "experts", "batch", "kv_seq", ...).  A rules
table maps logical names to the axes of a ``DeviceMesh``
(``mesh_dim_names``).  ``spec_for`` gives, per tensor dimension, the mesh
axis (or tuple of axes) that shards it, as ``repro``'s ``PartitionSpec``
holds them (trailing ``None``s dropped), so the two compare directly;
``placements`` turns that spec into DTensor placements, one per mesh
dimension.

Divisibility fallback: a dimension not divisible by its mesh axes' size
is replicated instead, and the fallback is recorded
(``recorded_fallbacks``).  A mesh axis shards at most one dimension of a
tensor.

``shard`` is the identity on a plain tensor (``repro``'s behaviour
without a mesh) and redistributes a DTensor to the spec's placements
(``with_sharding_constraint``'s counterpart).  The trainer's production
layout (``train/steps.py``) runs the model code on DTensors placed by
these rules, and there ``shard`` redistributes as GSPMD's constraint
does, MoE layers included ("experts" over "model"); a config that sets
``moe_ep`` keeps the explicit expert parallelism of
``models/moe_ep.py``.

``cut_to_shard`` turns a whole tensor that every rank holds into the
DTensor of this rank's shard without a collective (init, restore).
``allow_uneven_views`` is a process-wide registration every mesh path
makes before it runs a step.
"""

from __future__ import annotations

import contextlib
import threading
from typing import (Any, Dict, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

Axis = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, Axis]
Spec = Tuple[Axis, ...]

# repro's production rules: DP over pod+data, FSDP(param) over data,
# TP/EP over model
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,             # residual-stream sequence dim (SP shards this)
    "act_seq": None,         # sequence dim INSIDE attention/MLP
    "logits_seq": None,      # sequence dim of logits (vocab TP has priority)
    "kv_seq": None,          # long-context decode overrides this to "data"
    "embed": "data",         # FSDP axis for parameters
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "ffn": "model",
    "experts": "model",
    "expert_cap": None,
    "state": None,           # SSM state dim
    "ssm_heads": "model",
    "inner": "model",        # mamba d_inner
    "conv": None,
    "layers": None,
    "periods": None,
    "frames": None,
    "stack": None,
}

LONG_CONTEXT_OVERRIDES: Rules = {
    "kv_seq": "data",        # sequence-parallel KV cache / scan chunks
    "batch": "pod",
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Rules = dict(DEFAULT_RULES)
        self.fallbacks: list = []


_ctx = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[Rules] = None):
    """Activate a mesh (a ``DeviceMesh`` with named dimensions, or None)
    and logical rules for this thread."""
    prev = (_ctx.mesh, _ctx.rules, _ctx.fallbacks)
    _ctx.mesh = mesh
    _ctx.rules = dict(DEFAULT_RULES)
    if rules:
        _ctx.rules.update(rules)
    _ctx.fallbacks = []
    try:
        yield _ctx
    finally:
        _ctx.mesh, _ctx.rules, _ctx.fallbacks = prev


def current_mesh():
    return _ctx.mesh


def recorded_fallbacks() -> list:
    return list(_ctx.fallbacks)


def bound_to_ctx(fn):
    """``fn`` run under this thread's mesh and rules wherever it is
    called: a checkpointed layer's backward recompute runs on autograd's
    thread (the card's worker thread), outside the caller's context."""
    mesh, rules = _ctx.mesh, dict(_ctx.rules)
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with sharding_ctx(mesh, rules):
            return fn(*args, **kwargs)
    return run


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh, in its dimension order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _flat(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _axis_size(shape: Dict[str, int], axis: Axis) -> int:
    n = 1
    for a in _flat(axis):
        n *= shape.get(a, 1)
    return n


def _present(shape: Dict[str, int], axis: Axis) -> Axis:
    """Drop mesh axes that do not exist on this mesh (e.g. 'pod')."""
    kept = tuple(a for a in _flat(axis) if a in shape)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh=None, rules: Optional[Rules] = None) -> Spec:
    """The mesh axis of each dimension of ``shape`` from its logical name,
    with the divisibility fallback; ``logical`` may be shorter than the
    rank (trailing dims replicate).  () without a mesh."""
    mesh = mesh if mesh is not None else _ctx.mesh
    rules = rules or _ctx.rules
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    parts = []
    used: set = set()
    for i, dim in enumerate(shape):
        name = logical[i] if i < len(logical) else None
        axis = _present(sizes, rules.get(name)) if name else None
        # a mesh axis may shard at most one dimension
        if axis is not None and any(a in used for a in _flat(axis)):
            axis = None
        if axis is not None and dim % _axis_size(sizes, axis) != 0:
            _ctx.fallbacks.append((tuple(shape), tuple(logical), name, axis))
            axis = None
        used.update(_flat(axis))
        parts.append(axis)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` for the tensor dimension it shards, else ``Replicate()``.
    A dimension sharded over a tuple of axes is split by them in order,
    the first the outermost, as a ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, axis in enumerate(spec) if name in _flat(axis)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


class NamedSharding(NamedTuple):
    """Where a leaf lives: its mesh, its spec and the spec's placements."""
    mesh: Any
    spec: Spec
    placements: tuple


def named_sharding(mesh, spec: Spec) -> NamedSharding:
    return NamedSharding(mesh, spec, placements(spec, mesh))


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """A logical sharding constraint on an activation: the identity on a
    plain tensor or without a mesh; a DTensor is redistributed to the
    spec's placements."""
    if _ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(_ctx.mesh, live_placements(
        placements(spec_for(x.shape, logical), _ctx.mesh), _ctx.mesh))


def live_placements(pl: tuple, mesh) -> tuple:
    """``pl`` with a shard over a mesh dimension of size 1 (which holds
    the whole dimension) given as ``Replicate()``: the same data, and no
    sharded dimension for DTensor's strategies to carry."""
    from torch.distributed.tensor import Replicate
    return tuple(p if mesh.size(i) > 1 else Replicate()
                 for i, p in enumerate(pl))


def tree_shardings(tree_shapes: Any, tree_logical: Any, mesh=None,
                   rules: Optional[Rules] = None) -> Any:
    """A ``NamedSharding`` for each leaf of a tree of shaped leaves
    (tensors, ``meta`` tensors, ``TensorSpec``s) given the matching tree
    of logical-axis tuples."""
    mesh = mesh if mesh is not None else _ctx.mesh
    rules = rules or _ctx.rules

    def walk(shapes, logical):
        if isinstance(shapes, dict):
            return {k: walk(v, logical[k]) for k, v in shapes.items()}
        return named_sharding(
            mesh, spec_for(tuple(shapes.shape), logical, mesh, rules))

    return walk(tree_shapes, tree_logical)


def cut_to_shard(x: torch.Tensor, s: NamedSharding):
    """The DTensor of ``x`` (the whole tensor, the same on every rank of
    ``s.mesh``) on ``s``'s placements, cut locally: no collective.  The
    shard owns its memory, so the whole tensor is freed with ``x``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    d = distribute_tensor(x, s.mesh, s.placements, src_data_rank=None)
    loc = d.to_local()
    if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        d = DTensor.from_local(loc.clone(), s.mesh, s.placements,
                               run_check=False, shape=x.shape,
                               stride=x.stride())
    return d


def grad_onto_own_placements(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, but under autograd the gradient of this use of a
    DTensor is redistributed onto ``x``'s own placements before autograd
    adds it to other uses' (the no-op redistribute's backward): a tied
    embedding's gather and head hand back gradients on different
    placements, and torch 2.11's DTensor plans their sum as a Shard ->
    Partial move it cannot make.  The identity on a plain tensor."""
    if not hasattr(x, "placements"):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def on_local_shards(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that works along ``dim`` alone and is linear
    (each shard's result is the whole result's shard, Partial sums
    included): a DTensor not sharded along ``dim`` is mapped shard by
    shard, keeping its placements; a plain tensor directly."""
    if not hasattr(x, "placements"):
        return fn(x)
    from torch.distributed.tensor import DTensor
    d = dim % x.dim()
    if any(p.is_shard(d) for p in x.placements):
        raise ValueError(f"dimension {d} of {tuple(x.shape)} is sharded "
                         f"({x.placements})")
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def allow_uneven_views() -> None:
    """Let DTensor redistribute the input of a ``view`` or
    ``_unsafe_view`` (einsum's flatten) it cannot apply to the shards as
    they lie, as it does for ``reshape``, instead of refusing the op: a
    sharded dimension split unevenly (56 heads over 16 ranks), or, on
    torch 2.11, a flatten of two sharded dimensions (attention's batch
    over "data" and kv heads over "model"; torch 2.13 keeps that flatten
    sharded without moving anything).  The registration is process-wide:
    every path that runs a step on a mesh (the trainer's production
    layout, the dry run) calls it first."""
    try:
        from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
        from torch.distributed.tensor._ops._view_ops import \
            register_op_strategy_map
        for op in (torch.ops.aten.view.default,
                   torch.ops.aten._unsafe_view.default):
            register_op_strategy_map(op, torch.Tensor.view,
                                     schema_info=RuntimeSchemaInfo(1),
                                     strict_view=False)
    except (ImportError, TypeError):
        pass      # a torch whose views are not strict
