"""Parameter-spec trees.

A model is described by a nested dict of ``PSpec`` (shape + logical axes +
init), the same trees as ``repro.models.params``.  From one spec tree come
real initialized tensors (``init_tree``, on an explicit generator and its
device) and the parameter count.  ``params_from_numpy`` carries ``repro``'s
parameters across: the same nested-dict layout, layer leaves stacked on a
leading "layers" axis, so the carry is a tree map.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

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


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


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


def init_tree(specs: Any, gen: torch.Generator, default_dtype: str) -> Any:
    """Tensors on ``gen``'s device, drawn leaf by leaf in the spec tree's
    order: no float32 temporary larger than one leaf exists.  The same
    std rule as ``repro``; the draws differ (a torch generator is not a
    jax key), so parameters shared with ``repro`` come through
    ``params_from_numpy``."""
    dev = gen.device

    def one(spec: PSpec) -> torch.Tensor:
        dt = torch_dtype(spec.dtype or default_dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return x.mul_(_std(spec)).to(dt)

    return tree_map(one, specs)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """``repro`` parameters as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's tensors on ``device`` (None: the card), same
    dtypes (ml_dtypes bfloat16 arrays become torch.bfloat16)."""
    dev = resolve_device(device)

    def one(a) -> torch.Tensor:
        a = np.array(a)                  # a writable copy
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return tree_map(one, tree)


def param_count(specs: Any) -> int:
    return sum(int(np.prod(s.shape)) if s.shape else 1
               for s in tree_leaves(specs))
