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
``moe_ep`` routes its MoE tokens by ``models/moe_ep.py``'s explicit
hops on the same layout.

Each weight is placed at its use as ``repro``'s partitioned program
places it, not by DTensor's least-redistribution choice, which leaves
ranks of a "model" group repeating one product: ``use_weight`` and
``product_operands`` place a weight (and the activation's rows) for its
product, ``constrain`` reduces or gathers the result, ``on_own_rows``
runs attention and the SSD on each rank's own rows and heads.  All are identities on plain tensors and on a mesh whose every
dimension has size 1.

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
             mesh=None, rules: Optional[Rules] = None,
             record: bool = True) -> Spec:
    """The mesh axis of each dimension of ``shape`` from its logical name,
    with the divisibility fallback (recorded unless ``record`` is False);
    ``logical`` may be shorter than the rank (trailing dims replicate).
    () without a mesh."""
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
            if record:
                _ctx.fallbacks.append((tuple(shape), tuple(logical), name,
                                       axis))
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
    spec's placements, and on a mesh of more than one rank so is its
    gradient, as the transpose of with_sharding_constraint constrains the
    cotangent (a Partial gradient is reduced here, before the product
    that made the activation takes it)."""
    return _constrain(x, logical, True)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``shard`` where ``repro`` has no constraint and XLA's partitioner
    places the value: after a product placed by ``product_operands``, to
    reduce its Partial sum or gather its rows.  Its divisibility
    fallbacks are not ``repro``'s, and are not recorded."""
    return _constrain(x, logical, False)


def _constrain(x: torch.Tensor, logical, record: bool) -> torch.Tensor:
    if _ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = _ctx.mesh
    pl = live_placements(placements(spec_for(x.shape, logical,
                                             record=record), mesh), mesh)
    y = x.redistribute(mesh, pl)
    if all(mesh.size(i) == 1 for i in range(mesh.ndim)):
        return y
    return y.redistribute(mesh, pl)     # the gradient's move, backward


def _mesh_axes(sizes: Dict[str, int], *logical: str) -> set:
    """The mesh axes the current rules map any of ``logical`` to."""
    return {a for name in logical
            for a in _flat(_present(sizes, _ctx.rules.get(name)))}


def _fsdp_and_free(mesh) -> Tuple[set, set]:
    """The mesh axes that shard an FSDP axis of the weights ("embed"),
    and the tensor-parallel axes the activations' rows are replicated
    over ("model")."""
    sizes = mesh_shape(mesh)
    fsdp = _mesh_axes(sizes, "embed")
    free = _mesh_axes(sizes, "heads", "ffn", "vocab", "experts", "inner") \
        - fsdp - _mesh_axes(sizes, "batch")
    return fsdp, free


def use_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype`` for an elementwise use beside row-sharded
    activations (a norm's scale, a bias, a conv tap): the rank's own
    shard cast first, so that a gather moves ``dtype``, then gathered
    over every mesh dimension that shards an FSDP axis (the rules'
    "embed", "data" by default), a tensor-parallel shard ("model") kept.
    A product's weight goes through ``product_operands``.  The cast alone
    on a plain tensor, outside ``sharding_ctx``, or where every mesh
    dimension it would change has size 1 (no DTensor op beyond the
    cast)."""
    w = w.to(dtype)
    if _ctx.mesh is None or not hasattr(w, "placements"):
        return w
    return _placed(w, _weight_target(w, (), frozenset()))


def _weight_target(w: torch.Tensor, contract: Tuple[int, ...],
                   keep) -> list:
    """The placements ``product_operands`` gives ``w``: every FSDP shard
    gathered but over the mesh dimensions in ``keep``, a tensor-parallel
    shard kept, and over a tensor-parallel mesh dimension ``w`` is then
    whole on, the first dimension of ``contract`` that divides split
    there (nested under an FSDP shard it keeps)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = w.device_mesh
    fsdp, free = _fsdp_and_free(mesh)
    names = [n if mesh.size(i) > 1 else None
             for i, n in enumerate(mesh.mesh_dim_names)]
    target = [Replicate() if n in fsdp and i not in keep else p
              for i, (n, p) in enumerate(zip(names, w.placements))]
    for i, name in enumerate(names):
        if name in free and target[i].is_replicate():
            for c in contract:
                c %= w.dim()
                ways = mesh.size(i)
                for k, p in enumerate(target):
                    ways *= mesh.size(k) if p.is_shard(c) else 1
                if w.shape[c] % ways == 0:
                    target[i] = Shard(c)
                    break
    return target


def _placed(w: torch.Tensor, target) -> torch.Tensor:
    """``w`` redistributed onto ``target``: a shard moved from one mesh
    dimension to another of the same size by a permute (``_permuted``),
    else DTensor's own move."""
    if tuple(target) == tuple(w.placements):
        return w
    pair = _permute_pair(w, target)
    if pair is not None:
        return _Permute.apply(w, tuple(target), *pair)
    return w.redistribute(w.device_mesh, target)


def _permute_pair(w: torch.Tensor, target) -> Optional[Tuple[int, int]]:
    """(i, j) where ``w`` is ``Shard(c)`` over mesh dimension i and
    replicated over j, ``target`` the other way round, the two of one
    size, every other placement the same and none sharding c, on a mesh
    that spans the process group's world (its ranks are the world's);
    else None.  DTensor's redistribute would gather the whole of ``w``
    over i and slice it over j: 1/n of it moves by a permute."""
    import torch.distributed as dist
    mesh = w.device_mesh
    src, dst = tuple(w.placements), tuple(target)
    moved = [k for k in range(mesh.ndim) if src[k] != dst[k]]
    if len(moved) != 2 or mesh.mesh.numel() != dist.get_world_size():
        return None
    i, j = moved if src[moved[0]].is_shard() else moved[::-1]
    if not (src[i].is_shard() and dst[i].is_replicate()
            and src[j].is_replicate() and dst[j].is_shard(src[i].dim)
            and mesh.size(i) == mesh.size(j)):
        return None
    c = src[i].dim
    if any(p.is_shard(c) for k, p in enumerate(src) if k != i):
        return None
    return i, j


def _permuted(local: torch.Tensor, mesh, i: int, j: int) -> torch.Tensor:
    """This rank's ``local`` sent to the rank whose coordinates over
    mesh dimensions i and j are this rank's swapped, and that rank's
    received: an involution, so one all-to-all over the world with one
    nonzero split each way (a collective-permute; to itself on the
    diagonal)."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as fc
    coord = list(mesh.get_coordinate())
    coord[i], coord[j] = coord[j], coord[i]
    splits = [0] * dist.get_world_size()
    splits[int(mesh.mesh[tuple(coord)])] = local.numel()
    out = fc.all_to_all_single(local.contiguous().reshape(-1), splits,
                               splits, dist.group.WORLD)
    return fc.wait_tensor(out).view(local.shape)


class _Permute(torch.autograd.Function):
    """A weight's ``Shard(c)`` over mesh dimension i (its FSDP shard over
    "data") moved onto j ("model"), where ``_weight_target`` splits a
    contraction: rank (d, m) takes chunk m of dimension c from a rank
    whose coordinate over i is m, rank (m, d), which holds it (XLA's
    collective-permute), in place of DTensor's gather of the whole
    weight over i and slice over j.  The backward is the same permute:
    the gradient, each rank's rows' part over i and chunk m over j,
    comes back as chunk d over i, each rank's part over j (``Partial``):
    reduced over j, it is the FSDP shard's gradient.  The same with and
    without autograd."""

    @staticmethod
    def forward(ctx, w, target, i, j):
        from torch.distributed.tensor import DTensor
        mesh = w.device_mesh
        ctx.src, ctx.dst, ctx.ij = tuple(w.placements), target, (i, j)
        return DTensor.from_local(_permuted(w.to_local(), mesh, i, j), mesh,
                                  target, run_check=False, shape=w.shape,
                                  stride=w.stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial
        i, j = ctx.ij
        mesh = g.device_mesh
        want = list(ctx.dst)
        want[i] = Partial()
        if tuple(g.placements) != tuple(want):
            g = g.redistribute(mesh, want)
        back = list(ctx.src)
        back[j] = Partial()
        return (DTensor.from_local(_permuted(g.to_local(), mesh, i, j), mesh,
                                   back, run_check=False, shape=g.shape,
                                   stride=g.stride()), None, None, None)


def _contract_with(x: torch.Tensor, w: torch.Tensor,
                  pairs: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """``x`` sliced to match the shards of the dimensions ``w`` contracts
    with it: ``pairs`` of (w's dimension, x's dimension).  Where a mesh
    dimension shards a contracted dimension of ``w`` (``use_weight``'s
    split, or a "model" shard of heads or ffn) and ``x`` is replicated
    there, ``x`` takes the matching shard: a slice, nothing moves.  The
    slice is in autograd, so the weight's gradient is each rank's own
    part too, and x's gradient is gathered as the partitioned program's
    transpose gathers it.  ``x`` itself elsewhere."""
    if not (hasattr(x, "placements") and hasattr(w, "placements")):
        return x
    from torch.distributed.tensor import Shard
    target = list(x.placements)
    for i, (pw, px) in enumerate(zip(w.placements, x.placements)):
        if not px.is_replicate():
            continue
        for wd, xd in pairs:
            if pw.is_shard(wd % w.dim()):
                target[i] = Shard(xd % x.dim())
                break
    if tuple(target) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def product_operands(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
                     pairs: Tuple[Tuple[int, int], ...], rows: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, w) placed for a product of x's rows (dimension ``rows``) with
    a weight that contracts ``pairs`` of (w's dimension, x's dimension),
    in order of preference, as ``repro``'s partitioned program places
    them.  ``repro`` has no counterpart: XLA's SPMD partitioner makes
    this choice there, while DTensor would pick each product's placement
    by the least redistribution and leave ranks of a "model" group
    repeating one product.

      * w's own shard is cast to ``dtype`` first, so a gather moves it.
      * Every mesh dimension that shards an FSDP axis of w ("embed" over
        "data") is gathered, and a tensor-parallel shard ("model") kept:
        x's rows stay each rank's own.
      * Over a tensor-parallel mesh dimension w is then whole on (a
        divisibility fallback, or a rule mapping to None), w is split
        along the first contracted dimension that divides.  x is
        replicated there, so its matching shard is a slice
        (``_contract_with``, in autograd, so that w's gradient is each
        rank's own part too); the product is a Partial sum, which the
        ``constrain`` after it reduces.
      * But where x's rows divide over that dimension (the trainer's
        rows, not a decode step's few), x's rows are split there instead
        and w stays whole: each rank multiplies its own rows by the
        whole weight, the same sums as one process's, and the
        ``constrain`` after the product gathers the rows.  The same
        work a rank as a split contraction.
      * Over an FSDP mesh dimension that x's rows are not split over (a
        decode step's MoE buffer, whose capacity rows do not divide; a
        batch of one), w keeps its shard: gathered, every rank of that
        dimension would repeat the product.  x is sliced to the shard
        where it is contracted, and the product is a Partial sum there.

    DTensor's redistribute moves w; the gradients go back through it,
    onto each leaf's own placements.  On plain tensors (x, w in
    ``dtype``)."""
    w = w.to(dtype)
    if _ctx.mesh is None or not (hasattr(w, "placements")
                                 and hasattr(x, "placements")):
        return x, w
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    fsdp, free = _fsdp_and_free(mesh)
    keep = frozenset(i for i, n in enumerate(mesh.mesh_dim_names)
                     if n in fsdp and x.placements[i].is_replicate())
    ways = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(rows):
            ways *= mesh.size(i)
    split = list(x.placements)
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if (n > 1 and name in free and x.placements[i].is_replicate()
                and w.placements[i].is_replicate()
                and x.shape[rows] % (ways * n) == 0):
            split[i] = Shard(rows)
            ways *= n
    contract = tuple(wd for wd, _ in pairs)
    if tuple(split) != tuple(x.placements):
        x, contract = x.redistribute(mesh, split), ()
    w = _placed(w, _weight_target(w, contract, keep))
    return _contract_with(x, w, pairs), w


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) as one 2-D product over x's leading
    dimensions flattened: ``torch.matmul``'s own fold, bit for bit on
    plain tensors.  On DTensors ``torch.matmul`` may take its other
    path, w expanded to one copy a row of x."""
    return torch.mm(x.reshape(-1, x.shape[-1]), w).reshape(
        *x.shape[:-1], w.shape[-1])


def whole_where(x: torch.Tensor, other: torch.Tensor,
                dim: int) -> torch.Tensor:
    """``x`` gathered over each mesh dimension that shards ``other``
    along ``dim``: a decode step's query (one row, a few heads) meets a
    cache sharded along its sequence there, which should not move.
    ``x`` itself elsewhere."""
    if not (hasattr(x, "placements") and hasattr(other, "placements")):
        return x
    from torch.distributed.tensor import Replicate
    target = tuple(Replicate() if po.is_shard(dim % other.dim()) else px
                   for px, po in zip(x.placements, other.placements))
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def placed_as(x: torch.Tensor, ref: torch.Tensor, dims: int
              ) -> torch.Tensor:
    """``x`` on ``ref``'s placements over ``ref``'s first ``dims``
    dimensions, whose meaning ``x``'s share (rows, then heads), and
    replicated where ``ref`` shards a later one: a small per-row value
    moved to where a large one lies (a decode step's SSM state), so that
    the large one stays on its rank.  ``x`` itself elsewhere."""
    if not (hasattr(x, "placements") and hasattr(ref, "placements")):
        return x
    from torch.distributed.tensor import Replicate
    target = tuple(p if p.is_shard() and p.dim < dims else Replicate()
                   for p in ref.placements)
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def softmax_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.softmax`` over the last dimension.  On a DTensor sharded
    along it (a decode step's scores over the cache's sequence) the max
    and the sum are taken on each shard and reduced over the mesh
    (flash-decoding's partials, as ``repro``'s partitioned softmax
    reduces them), so that the scores do not move: DTensor's own
    softmax strategy gathers the sequence whole."""
    if not (hasattr(x, "placements")
            and any(p.is_shard(x.dim() - 1) for p in x.placements)):
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def heads_where_free(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, H, D) and the cache's k, v (B, T, Kv, D) split along
    their heads over each mesh dimension all three are replicated over
    (a long context's "pod": its batch of one and its cache's sequence
    leave it free), where the kv heads divide: slices, nothing moves,
    and no rank of that dimension repeats another's attention."""
    if not all(hasattr(t, "placements") for t in (q, k, v)):
        return q, k, v
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    spare = [i for i in range(mesh.ndim) if mesh.size(i) > 1
             and all(t.placements[i].is_replicate() for t in (q, k, v))
             and q.shape[2] % mesh.size(i) == 0
             and k.shape[2] % mesh.size(i) == 0]
    if not spare:
        return q, k, v

    def split(t):
        pl = [Shard(2) if i in spare else p
              for i, p in enumerate(t.placements)]
        return t.redistribute(mesh, pl)
    return split(q), split(k), split(v)


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


def on_own_rows(fn, args: Sequence[Optional[torch.Tensor]],
                dims: Sequence[Tuple[Optional[int], Optional[int]]],
                outs: Sequence[Tuple[Optional[int], Optional[int]]],
                trade_heads: bool = True):
    """``fn(*args)`` for an ``fn`` that works on each row and each head
    on its own (attention, the SSD), run on each rank's own rows and
    heads as ``repro``'s partitioned program runs it; ``dims[i]`` and
    ``outs[j]`` are (row dimension, head dimension) of argument i and
    result j, None where it has none (None arguments pass).  DTensor
    would place the flattened (batch, heads) dimensions by the least
    redistribution and may gather the heads.

    ``args[0]`` leads, and has both.  A mesh dimension that shards its
    rows splits every argument's rows.  Over a tensor-parallel one
    ("model") it is replicated on, the rows are split too where they
    divide, so no rank repeats another's work; with ``trade_heads`` also
    where it is head-sharded (arguments with heads trade them for rows:
    an all-to-all each way), for an ``fn`` whose heads share products.
    Else its heads stay split, and arguments without heads are used
    whole there.  An argument replicated where it is split is sliced
    (nothing moves).  The results come back on ``args[0]``'s own
    placements.  None on plain tensors, on a mesh whose every dimension
    has size 1, or where a split would be uneven or an argument lies
    another way."""
    lead = args[0]
    if not all(a is None or hasattr(a, "placements") for a in args):
        return None
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = lead.device_mesh
    if all(mesh.size(i) == 1 for i in range(mesh.ndim)):
        return None
    rd0, hd0 = dims[0]
    ways = 1
    for i, p in enumerate(lead.placements):
        if p.is_shard(rd0):
            ways *= mesh.size(i)
    _, free = _fsdp_and_free(mesh)
    split = []        # per mesh dimension: "rows", "heads" or None
    hways = 1
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names,
                                      lead.placements)):
        n = mesh.size(i)
        if p.is_shard(rd0):
            split.append("rows")
        elif (n > 1 and name in free and lead.shape[rd0] % (ways * n) == 0
              and (p.is_replicate() or (trade_heads and p.is_shard(hd0)))):
            split.append("rows")
            ways *= n
        elif p.is_shard(hd0):
            split.append("heads")
            hways *= n
        elif p.is_replicate():
            split.append(None)
        else:
            return None
    if lead.shape[rd0] % ways or any(
            a is not None and hd is not None and a.shape[hd] % hways
            for a, (_, hd) in zip(args, dims)):
        return None

    def want(rd, hd, grad=False):
        # an argument used whole where the work is split has a Partial
        # gradient there: each rank's part of the sum
        return tuple(Shard(rd) if s == "rows" and rd is not None else
                     Shard(hd) if s == "heads" and hd is not None else
                     Partial() if grad and s is not None else
                     Replicate() for s in split)

    local = []
    for a, (rd, hd) in zip(args, dims):
        if a is None:
            local.append(None)
            continue
        pl = want(rd, hd)
        if any(not (p == w or p.is_replicate() or (
                s == "rows" and hd is not None and p.is_shard(hd)))
               for s, p, w in zip(split, a.placements, pl)):
            return None
        local.append((a if tuple(a.placements) == pl else
                      a.redistribute(mesh, pl)).to_local(
                          grad_placements=want(rd, hd, grad=True)))
    back = []
    for r, (rd, hd) in zip(fn(*local), outs):
        d = DTensor.from_local(r, mesh, want(rd, hd), run_check=False)
        own = tuple(Shard(rd) if p.is_shard(rd0) else
                    Shard(hd) if p.is_shard(hd0) else Replicate()
                    for p in lead.placements)
        back.append(d if tuple(d.placements) == own else
                    d.redistribute(mesh, own))
    return tuple(back)


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
