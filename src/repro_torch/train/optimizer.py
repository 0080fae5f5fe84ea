"""AdamW in plain PyTorch, a port of ``repro.train.optimizer`` (the
memory knobs of the large configs included):

  * ``state_dtype``   — bf16 first/second moments,
  * ``factored_v``    — Adafactor-style rank-1 second moment for >=2-D
                        params (v is stored as row/col means),
  * global-norm gradient clipping (float32), decoupled weight decay on
    every leaf of two or more dimensions (the layer-stacked (L, D) norm
    weights included, as in ``repro``),
  * linear-warmup + cosine-decay schedule, bias correction with step + 1.

``torch.optim.AdamW`` computes something else (per-tensor clipping is not
global, its decay skips nothing, no factored moment), so this is the
update written out as tensor math, leaf by leaf in JAX's leaf order.
Unlike ``repro``'s functional update, ``adamw_update`` writes the new
parameters and moments into the tensors it is given (``repro``'s trainer
donates them) and returns the same trees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.params import (torch_dtype, tree_flatten,
                                       tree_flatten_up_to, tree_map)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # moments dtype
    factored_v: bool = False         # rank-1 second moment for >=2-D params


def schedule(cfg: OptConfig, step: Tensor) -> Tensor:
    """The learning rate at ``step`` (a 0-d tensor), float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    floor = cfg.min_lr_ratio
    return cfg.lr * warm * (floor + (1 - floor) * cos)


def _factored(p: Tensor) -> bool:
    return p.dim() >= 2


def adamw_init(cfg: OptConfig, params: Any) -> Dict[str, Any]:
    dt = torch_dtype(cfg.state_dtype)

    def m_like(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    def v_like(p):
        if cfg.factored_v and _factored(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            return {"row": torch.zeros(p.shape[:-1], **f32),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(m_like, params), "v": tree_map(v_like, params)}


def _vhat(cfg: OptConfig, v, g2: Tensor) -> Tuple[Any, Tensor]:
    """Update the second moment and return (new_v, per-element estimate)."""
    if isinstance(v, dict):                       # factored
        row = cfg.b2 * v["row"] + (1 - cfg.b2) * torch.mean(g2, dim=-1)
        col = cfg.b2 * v["col"] + (1 - cfg.b2) * torch.mean(g2, dim=-2)
        denom = torch.clamp(torch.mean(row, dim=-1, keepdim=True),
                            min=1e-30)
        est = (row / denom)[..., None] * col[..., None, :]
        return {"row": row, "col": col}, est
    new_v = cfg.b2 * v.float() + (1 - cfg.b2) * g2
    return new_v.to(v.dtype), new_v


def global_norm(tree: Any) -> Tensor:
    """sqrt of the float32 sum of squares over every leaf, in JAX's leaf
    order.  A DTensor leaf's sum of squares is reduced over the ranks
    (its ``Partial`` sum made whole), so over DTensors the norm is one
    plain float32 scalar, the same on every rank."""
    total = None
    for x in tree_flatten(tree)[0]:
        sq = torch.sum(torch.square(x.float()))
        if hasattr(sq, "full_tensor"):
            sq = sq.full_tensor()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _write(dst: Tensor, src: Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``src`` first takes ``dst``'s
    placements (a moment's row mean over a sharded dimension comes back
    ``Partial`` or on other placements than the moment)."""
    if hasattr(dst, "placements") and src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Any, grads: Any,
                 opt_state: Dict[str, Any], step: Tensor
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Tensor]]:
    """One AdamW step at ``step`` (0-d int tensor, before the increment).
    Writes into ``params`` and ``opt_state`` and returns them with
    {"grad_norm", "lr"}, the clipping norm the global norm of
    ``grads``."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** (step.to(torch.float32) + 1)
    b2c = 1 - cfg.b2 ** (step.to(torch.float32) + 1)

    flat_p, struct = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(opt_state["m"])[0]
    flat_v = tree_flatten_up_to(struct, opt_state["v"])
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float() * clip
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v2, vest = _vhat(cfg, v, torch.square(g))
        del g
        mhat = m2 / b1c
        upd = mhat / (torch.sqrt(vest.float() / b2c) + cfg.eps)
        del mhat, vest
        if p.dim() >= 2:                           # decoupled weight decay
            upd = upd + cfg.weight_decay * p.float()
        _write(p, p.float() - lr * upd)
        _write(m, m2)
        if isinstance(v, dict):
            _write(v["row"], v2["row"])
            _write(v["col"], v2["col"])
        else:
            _write(v, v2)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def opt_state_axes(cfg: OptConfig, param_axes: Any) -> Dict[str, Any]:
    """Logical axes for the optimizer state (mirrors params; factored v
    drops the factored dim)."""
    def v_axes(ax):
        if cfg.factored_v and len(ax) >= 2:
            return {"row": tuple(ax[:-1]), "col": tuple(ax[:-2] + ax[-1:])}
        return ax

    return {"m": param_axes, "v": tree_map(v_axes, param_axes)}
