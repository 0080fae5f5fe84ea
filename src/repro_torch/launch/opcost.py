"""Per-device cost of a PyTorch program, counted op by op: the port's
counterpart of ``repro.launch.hlocost``.

``repro`` re-derives the roofline inputs from post-partitioning HLO text.
The port has no HLO: ``OpCounter`` is a ``TorchDispatchMode`` that sees
every aten op the program runs, on the tensors each device really holds.
Under DTensor it sits *below* the sharding layer: an op on DTensors is
handed back to DTensor (``NotImplemented``), which redistributes its
operands and runs the op on their local shards, and the counter sees
those local ops and the collectives DTensor issued.  Counted above
DTensor, a batch-sharded matmul would count the global FLOPs, the mesh's
size times too many.

  * FLOPs — matmuls and convolutions only, as ``hlocost`` counts dots and
    convolutions: the formulas of ``torch.utils.flop_counter``'s registry
    on the local shapes.  They are also kept by operand type
    (``flops_by_dtype``: "bfloat16", "float32", or "tf32" for a float32
    product while ``torch.backends.cuda.matmul.allow_tf32`` is on), which
    the roofline divides by each type's peak, and by op and local shapes
    (``flops_by_op``), which shows the ops a sharding leaves unsharded.
  * HBM bytes — ``hlocost``'s fusion-boundary rule with every aten op a
    boundary (eager PyTorch fuses nothing): output bytes plus operand
    bytes.  Views and aliases are free; gathers, index and slice reads
    count twice their output (read the slice, write it); scatters, index
    writes and slice writes twice their update; a collective twice its
    output.
  * collective wire bytes — per ``_c10d_functional`` collective (what
    DTensor issues), its output bytes times ``repro``'s ring factor for
    its group's size (``WIRE_FACTOR``).  An all-to-all that takes its
    whole output from one rank and sends its whole input to one rank is
    a permute (``models/sharding.py::_permuted``), XLA's
    collective-permute: its output bytes, once.  They are also kept by
    kind, mesh axis, group size, output shape and dtype (``wire_by_op``,
    with ``wire_count_by_op``), the largest first in ``top_wire``: which
    tensor moves, and over which group (an all-gather's output holds the
    shards stacked along dimension 0).

Only ops on tensors of one device type are counted (``device``): the dry
run traces ``meta`` shards, and DTensor's own bookkeeping (index
arithmetic on small CPU tensors) and its shape propagation (on
``FakeTensor``s of the global shapes) are not the program's work.

With ``track_memory`` the counter also follows the storages the program
allocates on that device: ``peak_bytes`` is the most that were alive at
once, above whatever existed before (the arguments).
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# ring-algorithm wire bytes per output byte, by collective and group size
# N (``repro.launch.roofline``'s table)
WIRE_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: float(n - 1),
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}

# functional collective -> its HLO counterpart's kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")

# matmul and convolution ops: the only FLOPs counted (hlocost's dots and
# convolutions)
_FLOP_OPS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
             aten._convolution, aten.convolution_backward)

# no data moved: bookkeeping, allocation without a write, waits
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "wait_tensor",
         "_wrap_tensor_autograd", "_to_copy_noop", "set_", "resize_"}
# read a slice of the input: twice the output's bytes
_SLICE_OUT = {"index_select", "gather", "index", "embedding",
              "narrow_copy", "slice_copy", "select_copy", "take",
              "_unsafe_index"}
# write a slice of the output: twice the update's bytes (the update's
# argument position)
_SLICE_IN = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
             "scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
             "index_add": 3, "index_add_": 3, "index_copy": 3,
             "index_copy_": 3, "slice_scatter": 1, "select_scatter": 1,
             "diagonal_scatter": 1, "as_strided_scatter": 1}

_PLAIN = (torch.Tensor, torch.nn.Parameter)


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def flop_kind(dtype: torch.dtype) -> str:
    """The type a matmul of ``dtype`` operands runs in on the card: a
    float32 product runs in TF32 while cuBLAS is allowed to."""
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return str(dtype).removeprefix("torch.")


@functools.lru_cache(maxsize=None)
def _named_group(name: str) -> Tuple[int, str]:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _group(_resolve_process_group(name))


def _group(group) -> Tuple[int, str]:
    """(size, mesh axis) of a functional collective's group (its last
    positional argument: a group name, or the group itself); the axis is
    the mesh dimension a ``DeviceMesh`` made the group for ("data",
    "model"), else "world" or the group's own description."""
    if isinstance(group, str):
        return _named_group(group)
    desc = getattr(group, "group_desc", "") or ""
    axis = desc.removeprefix("mesh_") if desc.startswith("mesh_") else \
        "world" if desc == "default_pg" else desc or "?"
    return group.size(), axis


def _is_permute(args) -> bool:
    """An ``all_to_all_single(input, output_split_sizes,
    input_split_sizes, group)`` whose output comes from one rank and
    whose input goes to one: a permute."""
    out_splits, in_splits = args[1], args[2]
    return (isinstance(out_splits, (list, tuple)) and
            isinstance(in_splits, (list, tuple)) and
            sum(1 for s in out_splits if s) == 1 and
            sum(1 for s in in_splits if s) == 1)


@dataclasses.dataclass
class ModuleCost:
    """``hlocost.ModuleCost``'s fields, per device; ``float64_ops`` is the
    counterpart of ``roofline.check_no_f64`` and ``ops`` the number of ops
    counted."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    coll_out_bytes: float = 0.0
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    float64_ops: List[str] = dataclasses.field(default_factory=list)
    ops: int = 0
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    wire_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    wire_count_by_op: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    def top_flops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` (op and local shapes, FLOPs) that weigh most."""
        return sorted(self.flops_by_op.items(), key=lambda kv: -kv[1])[:n]

    def top_wire(self, n: int = 10) -> List[Tuple[str, float, int]]:
        """The ``n`` (kind, mesh axis, group size, output shape and
        dtype; wire bytes; count) that move most."""
        return [(k, b, self.wire_count_by_op[k]) for k, b in sorted(
            self.wire_by_op.items(), key=lambda kv: -kv[1])[:n]]

    def to_dict(self):
        return dataclasses.asdict(self)


class OpCounter(TorchDispatchMode):
    """``with OpCounter("meta") as oc: ...`` then ``oc.cost`` (and, with
    ``track_memory``, ``oc.peak_bytes``)."""

    def __init__(self, device: str = "meta", track_memory: bool = False):
        super().__init__()
        self.device = torch.device(device).type
        self.cost = ModuleCost()
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        # a DTensor (or any wrapper) works out its local ops itself; they
        # come back here on plain tensors
        if any(t not in _PLAIN and not issubclass(t, FakeTensor)
               for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out          # DTensor's shape propagation
        if not any(t.device.type == self.device for t in outs or ins):
            return out
        self._count(func, args, kwargs, ins, outs)
        if self.track_memory:
            self._track(ins, outs)
        return out

    # ------------------------------------------------------------ counting
    def _count(self, func, args, kwargs, ins, outs) -> None:
        c = self.cost
        c.ops += 1
        name = func.overloadpacket.__name__
        ns = func.namespace
        if any(o.dtype == torch.float64 for o in outs) and \
                len(c.float64_ops) < 20:
            c.float64_ops.append(str(func))
        if ns in _COLLECTIVE_NS and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            if kind == "all-to-all" and _is_permute(args):
                kind = "collective-permute"
            out_b = sum(tensor_bytes(o) for o in outs)
            size, axis = _group(args[-1])
            n = max(size, 2)
            wire = WIRE_FACTOR[kind](n) * out_b
            c.wire_bytes += wire
            c.coll_out_bytes += out_b
            c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
            c.hbm_bytes += 2.0 * out_b
            key = " ".join([kind, axis, f"n={n}"] + [
                f"{tuple(o.shape)} {str(o.dtype).removeprefix('torch.')}"
                for o in outs])
            c.wire_by_op[key] = c.wire_by_op.get(key, 0.0) + wire
            c.wire_count_by_op[key] = c.wire_count_by_op.get(key, 0) + 1
            return
        if func.overloadpacket in _FLOP_OPS:
            from torch.utils.flop_counter import flop_registry
            out = outs[0] if len(outs) == 1 else tuple(outs)
            f = float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            c.flops += f
            kind = flop_kind(ins[0].dtype)
            c.flops_by_dtype[kind] = c.flops_by_dtype.get(kind, 0.0) + f
            key = (f"{name} " + " x ".join(str(tuple(t.shape)) for t in ins)
                   + f" {kind}")
            c.flops_by_op[key] = c.flops_by_op.get(key, 0.0) + f
        if not outs or name in _FREE or func.is_view:
            return
        if name in _SLICE_OUT:
            c.hbm_bytes += 2.0 * sum(tensor_bytes(o) for o in outs)
        elif name in _SLICE_IN:
            pos = _SLICE_IN[name]
            upd = args[pos] if len(args) > pos else None
            c.hbm_bytes += 2.0 * (tensor_bytes(upd)
                                  if isinstance(upd, torch.Tensor)
                                  else sum(tensor_bytes(o) for o in outs))
        else:
            reads = ins[1:] if name == "copy_" else ins
            c.hbm_bytes += (sum(tensor_bytes(o) for o in outs)
                            + sum(tensor_bytes(t) for t in reads))

    # -------------------------------------------------------------- memory
    def _track(self, ins, outs) -> None:
        """Register each output storage on the counted device that is not
        an input's (a new allocation, not a view or an in-place write)."""
        held = {id(t.untyped_storage()) for t in ins
                if t.device.type == self.device}
        for o in outs:
            if o.device.type != self.device:
                continue
            st = o.untyped_storage()
            key = id(st)
            if key in held or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)


def count(fn, *args, device: str = "meta", **kwargs):
    """(fn's result, its ModuleCost) counted on ``device``."""
    with OpCounter(device) as oc:
        out = fn(*args, **kwargs)
    return out, oc.cost
