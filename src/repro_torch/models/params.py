"""Parameter-spec trees.

A model is described by a nested dict of ``PSpec`` (shape + logical axes +
init), the same trees as ``repro.models.params``.  From one spec tree come
real initialized tensors (``init_tree``, on an explicit generator and its
device), ``meta`` stand-ins (``shape_tree``: no allocation), the
logical-axes tree, the parameter count and bytes.  ``params_from_numpy``
carries ``repro``'s parameters across: the same nested-dict layout, layer
leaves stacked on a leading "layers" axis, so the carry is a tree map.

``tree_map`` and ``tree_leaves`` walk dicts in insertion order.
``tree_flatten`` / ``tree_unflatten`` walk them in JAX's order (keys
sorted, as ``jax.tree.flatten``): the optimizer's flat loops and the
checkpoint's ``leaf_<i>`` files use it, so leaf i is the same tensor in
both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | embed | zeros | ones | small
    scale: float = 1.0
    dtype: Optional[str] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor to allocate (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


LEAF = object()   # a leaf's place in a structure


def tree_flatten(tree: Any) -> Tuple[list, Any]:
    """(leaves, structure) in JAX's order: nested dicts with their keys
    sorted, everything else a leaf.  The structure is the same dicts with
    ``LEAF`` in each leaf's place."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        leaves.append(t)
        return LEAF

    return leaves, walk(tree)


def tree_unflatten(structure: Any, leaves: Sequence) -> Any:
    """The inverse of ``tree_flatten``."""
    it = iter(leaves)

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        return next(it)

    out = walk(structure)
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_flatten_up_to(structure: Any, tree: Any) -> list:
    """The subtrees of ``tree`` at ``structure``'s leaves, in its order
    (``PyTreeDef.flatten_up_to``): a factored second moment's
    {"row", "col"} dict stays one entry."""
    if isinstance(structure, dict):
        if not isinstance(tree, dict) or set(tree) != set(structure):
            raise ValueError("tree does not have the structure's keys")
        return [x for k in structure
                for x in tree_flatten_up_to(structure[k], tree[k])]
    return [tree]


def treedef_str(structure: Any) -> str:
    """``str(treedef)`` of the same tree in JAX: ``PyTreeDef({'a': *})``."""
    def walk(s):
        if isinstance(s, dict):
            return "{" + ", ".join(f"{k!r}: {walk(v)}"
                                   for k, v in s.items()) + "}"
        return "*"
    return f"PyTreeDef({walk(structure)})"


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string ("bfloat16", "float32") as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _std(spec: PSpec) -> float:
    if spec.init == "embed":
        return 0.02 * spec.scale
    if spec.init == "small":
        return 1e-3 * spec.scale
    # lecun-style: fan-in is the second-to-last dim for rank>=2 (layer-stacked
    # params share the same per-layer fan-in, so the leading dims are ignored)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return spec.scale / np.sqrt(max(fan_in, 1))


def init_leaf(spec: PSpec, gen: torch.Generator,
              default_dtype: str) -> torch.Tensor:
    """One leaf of ``init_tree`` on ``gen``'s device (its draws, taken
    from ``gen``'s stream where it stands)."""
    dev = gen.device
    dt = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=dev)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=dev)
    return x.mul_(_std(spec)).to(dt)


def init_tree(specs: Any, gen: torch.Generator, default_dtype: str) -> Any:
    """Tensors on ``gen``'s device, drawn leaf by leaf in the spec tree's
    order: no float32 temporary larger than one leaf exists.  The same
    std rule as ``repro``; the draws differ (a torch generator is not a
    jax key), so parameters shared with ``repro`` come through
    ``params_from_numpy``."""
    return tree_map(lambda spec: init_leaf(spec, gen, default_dtype), specs)


def shape_tree(specs: Any, default_dtype: str) -> Any:
    """``meta`` tensors of each spec's shape and dtype (no allocation)."""
    return tree_map(lambda s: torch.empty(
        s.shape, dtype=torch_dtype(s.dtype or default_dtype),
        device="meta"), specs)


def axes_tree(specs: Any) -> Any:
    return tree_map(lambda s: s.axes, specs)


def param_bytes(specs: Any, default_dtype: str) -> int:
    total = 0
    for s in tree_leaves(specs):
        n = int(np.prod(s.shape)) if s.shape else 1
        total += n * torch_dtype(s.dtype or default_dtype).itemsize
    return total


# bfloat16 outside torch: numpy has no such dtype, so the port holds a
# bf16 array as its 2-byte words under a void dtype, which is how an
# ml_dtypes bfloat16 array (repro's) reads without ml_dtypes ('<V2')
BF16_NUMPY = np.dtype("V2")


def is_bf16_numpy(a: np.ndarray) -> bool:
    """An ml_dtypes bfloat16 array, or 2-byte void words standing for one."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def tensor_to_numpy(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` (never a view of a CPU tensor's memory); a
    bfloat16 tensor's words as ``BF16_NUMPY``."""
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(BF16_NUMPY)
    return x.numpy()


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """``repro`` parameters as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's tensors on ``device`` (None: the card), same
    dtypes (bfloat16 arrays, ml_dtypes' or ``BF16_NUMPY`` words, become
    torch.bfloat16)."""
    dev = resolve_device(device)

    def one(a) -> torch.Tensor:
        a = np.array(a)                  # a writable copy
        if is_bf16_numpy(a):
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return tree_map(one, tree)


def param_count(specs: Any) -> int:
    return sum(int(np.prod(s.shape)) if s.shape else 1
               for s in tree_leaves(specs))
