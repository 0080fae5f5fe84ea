"""Unified model API, mirroring ``repro.models.api``:

    param_specs / init_params / param_shapes / param_axes / param_count
    loss(cfg, params, batch)              -- training
    apply(cfg, params, batch)             -- full logits
    prefill / decode_step                 -- serving
    cache_specs(cfg, batch, max_len)      -- decode-cache TensorSpecs
    input_specs(cfg, shape)               -- per-(arch x shape) stand-ins
    pad_cache(cfg, cache, max_len)

Every family is ported: dense, moe and vlm (``transformer``), ssm
(``mamba_lm``), hybrid (``hybrid``) and encdec (``encdec``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import encdec as E
from repro_torch.models import hybrid as H
from repro_torch.models import mamba_lm as ML
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models.params import TensorSpec

_FAMILY_MODULE = {
    "dense": T, "moe": T, "vlm": T,
    "ssm": ML, "hybrid": H, "encdec": E,
}


def module(cfg: ModelConfig):
    return _FAMILY_MODULE[cfg.family]


def param_specs(cfg: ModelConfig) -> Any:
    return module(cfg).specs(cfg)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Any:
    """Parameters drawn from ``gen`` on its device."""
    return P.init_tree(param_specs(cfg), gen, cfg.param_dtype)


def param_shapes(cfg: ModelConfig) -> Any:
    """``meta`` tensors of every parameter (no allocation)."""
    return P.shape_tree(param_specs(cfg), cfg.param_dtype)


def param_axes(cfg: ModelConfig) -> Any:
    return P.axes_tree(param_specs(cfg))


def param_count(cfg: ModelConfig) -> int:
    return P.param_count(param_specs(cfg))


def loss(cfg: ModelConfig, params: Any, batch: Dict
         ) -> Tuple[torch.Tensor, Dict]:
    return module(cfg).loss(cfg, params, batch)


def apply(cfg: ModelConfig, params: Any, batch: Dict):
    return module(cfg).apply(cfg, params, batch)


def prefill(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
            frontend=None, last=None):
    """(cache, float32 logits (B,V)) of the prompt ``tokens``: the logits
    of token position ``last`` (B,), counted over the tokens alone, or of
    the final row when ``last`` is None."""
    return module(cfg).prefill(cfg, params, tokens, frontend, last)


def decode_step(cfg: ModelConfig, params: Any, cache: Dict,
                tokens: torch.Tensor):
    return module(cfg).decode_step(cfg, params, cache, tokens)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Tuple[Dict, Dict]:
    mod = module(cfg)
    if mod is T:
        return T.kv_cache_specs(cfg, batch, max_len)
    return mod.cache_specs(cfg, batch, max_len)


def pad_cache(cfg: ModelConfig, cache: Dict, max_len: int) -> Dict:
    """Pad a fresh-from-prefill cache out to ``max_len`` KV slots so decode
    steps can write past the prefill length (SSM caches are O(1): no-op).
    Only the self-attention ``k``/``v`` grow: encdec's cross ``xk``/``xv``
    keep their F encoder rows."""
    if module(cfg) is ML:
        return cache
    out = dict(cache)
    for key in ("k", "v"):
        arr = cache[key]
        pad = max_len - arr.shape[2]
        if pad > 0:
            # (L, B, S, Kv, D): pad dim 2 at its end
            out[key] = torch.nn.functional.pad(arr, (0, 0, 0, 0, 0, pad))
    return out


# ---------------------------------------------------------------------------
# per-(arch x shape) input stand-ins
# ---------------------------------------------------------------------------

def _frontend_spec(cfg: ModelConfig, batch: int):
    return (TensorSpec((batch, cfg.num_frontend_tokens, cfg.d_model),
                       P.torch_dtype(cfg.dtype)),
            ("batch", "frames", None))


def token_len(cfg: ModelConfig, seq_len: int) -> int:
    """The token run of a ``seq_len`` context: vlm prepends its patch
    embeddings inside the context budget; encdec frames live in a
    separate encoder sequence."""
    if cfg.family == "vlm":
        return seq_len - cfg.num_frontend_tokens
    return seq_len


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[Dict, Dict]:
    """(TensorSpec tree, logical-axes tree) for one sweep cell.

    train   -> {tokens, targets[, frontend]}
    prefill -> {tokens[, frontend]}
    decode  -> {tokens (B,1), cache}  (one new token against a KV/SSD
               cache of ``seq_len``)
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        t = token_len(cfg, s)
        specs = {"tokens": TensorSpec((b, t), i32)}
        axes = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            specs["targets"] = TensorSpec((b, t), i32)
            axes["targets"] = ("batch", "seq")
        if cfg.family in ("vlm", "encdec"):
            specs["frontend"], axes["frontend"] = _frontend_spec(cfg, b)
        return specs, axes
    if shape.kind == "decode":
        cshapes, caxes = cache_specs(cfg, b, s)
        return ({"tokens": TensorSpec((b, 1), i32), "cache": cshapes},
                {"tokens": ("batch", None), "cache": caxes})
    raise ValueError(shape.kind)


def make_zero_inputs(cfg: ModelConfig, shape: ShapeSpec,
                     device: DeviceLike = None) -> Dict:
    """Zero tensors matching ``input_specs`` on ``device`` (None: the
    card), for small configs."""
    dev = resolve_device(device)
    specs, _ = input_specs(cfg, shape)
    return P.tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype,
                                             device=dev), specs)
