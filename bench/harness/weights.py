"""The weights of a run, drawn from the seed on the device.

Shapes, leaf names and dtypes come from the port's own parameter specs
(``api.param_specs``): those are what its entry points take.  The values
are the benchmark's: one ``randn`` a dtype over a flat buffer on a
``torch.Generator`` of the device, each leaf a view of it scaled by its
standard deviation (1/sqrt(fan-in) for a projection, 0.02 for the
embedding and the output head), norms at one.  The same seed gives the
same tensors, so the reference gets them again by drawing again.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from bench.harness.seeds import stream_seed

# leading axes that stack copies of a weight rather than feed its product
_STACK_AXES = ("layers", "experts")


def fan_in(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> int:
    """The contraction size of a projection weight, past its leading
    stacked axes: ``embed`` where the weight maps out of the model width,
    else every axis but the last (the output)."""
    dims = list(zip(shape, axes))
    while dims[0][1] in _STACK_AXES:
        dims.pop(0)
    if dims[-1][1] != "embed":
        return math.prod(n for n, a in dims if a == "embed")
    return math.prod(n for n, _ in dims[:-1])


def std(spec) -> float:
    if spec.init == "embed":
        return 0.02
    return 1.0 / math.sqrt(fan_in(spec.shape, spec.axes))


def draw(cfg, seed: int, device) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` for ``seed`` on ``device``."""
    from repro_torch.models import api
    from repro_torch.models.params import (torch_dtype, tree_flatten,
                                           tree_unflatten)
    specs, struct = tree_flatten(api.param_specs(cfg))
    dtypes = [torch_dtype(s.dtype or cfg.param_dtype) for s in specs]
    drawn = [s.init in ("normal", "embed", "small") for s in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "weights"))
    leaves = [None] * len(specs)
    for dt in sorted(set(dtypes), key=str):
        idx = [i for i in range(len(specs)) if drawn[i] and dtypes[i] == dt]
        total = sum(math.prod(specs[i].shape) for i in idx)
        flat = torch.randn(total, generator=gen, dtype=dt, device=device)
        at = 0
        for i in idx:
            n = math.prod(specs[i].shape)
            leaves[i] = flat[at:at + n].view(specs[i].shape).mul_(
                std(specs[i]))
            at += n
    for i, s in enumerate(specs):
        if s.init == "ones":
            leaves[i] = torch.ones(s.shape, dtype=dtypes[i], device=device)
        elif s.init == "zeros":
            leaves[i] = torch.zeros(s.shape, dtype=dtypes[i], device=device)
        elif leaves[i] is None:
            raise ValueError(f"unknown init {s.init!r}")
    return tree_unflatten(struct, leaves)


def as_float32(tree: Any) -> Any:
    """The reference's copy: every leaf in float32."""
    if isinstance(tree, dict):
        return {k: as_float32(v) for k, v in tree.items()}
    return tree.float()
