"""Unified model API, mirroring ``repro.models.api`` for what the port has:

    param_specs / init_params / param_count
    apply(cfg, params, batch)             -- full logits
    prefill / decode_step                 -- serving
    cache_specs(cfg, batch, max_len)      -- decode-cache TensorSpecs
    pad_cache(cfg, cache, max_len)

The dense family is ported.  The moe and vlm families of the transformer
module and the ssm, hybrid and encdec modules raise ``NotImplementedError``
(ROADMAP Queue 1 item 10); ``loss`` waits for the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models import transformer as T


def module(cfg: ModelConfig):
    T.require_dense(cfg)
    return T


def param_specs(cfg: ModelConfig) -> Any:
    return module(cfg).specs(cfg)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Any:
    """Parameters drawn from ``gen`` on its device."""
    return P.init_tree(param_specs(cfg), gen, cfg.param_dtype)


def param_count(cfg: ModelConfig) -> int:
    return P.param_count(param_specs(cfg))


def apply(cfg: ModelConfig, params: Any, batch: Dict):
    return module(cfg).apply(cfg, params, batch)


def prefill(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
            frontend=None):
    return module(cfg).prefill(cfg, params, tokens, frontend)


def decode_step(cfg: ModelConfig, params: Any, cache: Dict,
                tokens: torch.Tensor):
    return module(cfg).decode_step(cfg, params, cache, tokens)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Tuple[Dict, Dict]:
    return module(cfg).kv_cache_specs(cfg, batch, max_len)


def pad_cache(cfg: ModelConfig, cache: Dict, max_len: int) -> Dict:
    """Pad a fresh-from-prefill cache out to ``max_len`` KV slots so decode
    steps can write past the prefill length."""
    module(cfg)
    out = dict(cache)
    for key in ("k", "v"):
        arr = cache[key]
        pad = max_len - arr.shape[2]
        if pad > 0:
            # (L, B, S, Kv, D): pad dim 2 at its end
            out[key] = torch.nn.functional.pad(arr, (0, 0, 0, 0, 0, pad))
    return out
