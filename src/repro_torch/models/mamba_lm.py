"""Mamba-2 language model (family "ssm"): embedding -> N x (norm + SSD
mixer) -> final norm -> tied unembedding.  Mirrors
``repro.models.mamba_lm``.  Attention-free: no flash kernel runs, and
the decode cache is O(1) in context length.

The layers run as a Python loop over the stacked "layers" axis where
``repro`` scans.  ``decode_step`` writes the cache's tensors in place:
the new cache shares them with ``cache``.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.params import TensorSpec, torch_dtype

Array = torch.Tensor


def layer_specs(cfg: ModelConfig) -> Dict:
    return {"ln": L.rmsnorm_spec(cfg.d_model), "mixer": S.ssm_specs(cfg)}


def specs(cfg: ModelConfig) -> Dict:
    return {
        "embed": L.embedding_specs(cfg),
        "layers": T.stack_specs(layer_specs(cfg), cfg.num_layers),
    }


def _block(cfg: ModelConfig, p: Dict, x: Array) -> Array:
    return x + S.ssm_block(cfg, p["mixer"],
                           L.rmsnorm(x, p["ln"], cfg.norm_eps))


def hidden_states(cfg: ModelConfig, params: Dict, batch: Dict
                  ) -> Tuple[Array, Array]:
    x = L.embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
    block = T.remat_wrap(cfg, functools.partial(_block, cfg))
    for i in range(cfg.num_layers):
        x = block(T.layer_params(params, i), x)
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def apply(cfg: ModelConfig, params: Dict, batch: Dict) -> Tuple[Array, Array]:
    x, aux = hidden_states(cfg, params, batch)
    return L.unembed(cfg, params["embed"], x), aux


def loss(cfg: ModelConfig, params: Dict, batch: Dict,
         aux_weight: float = 0.0) -> Tuple[Array, Dict]:
    x, aux = hidden_states(cfg, params, batch)
    ce, denom = T.chunked_xent(cfg, params["embed"], x,
                               batch["targets"], batch.get("loss_mask"))
    return ce, {"loss": ce, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params: Dict, tokens: Array,
            frontend=None, last=None) -> Tuple[Dict, Array]:
    """Returns (cache, logits (B,V) of token position ``last`` (B,), or of
    the final row when ``last`` is None)."""
    del frontend
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    caches = []
    for i in range(cfg.num_layers):
        lp = T.layer_params(params, i)
        h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
        out, cache = S.ssm_block(cfg, lp["mixer"], h, return_cache=True)
        x = x + out
        caches.append(cache)
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed_row(cfg, params["embed"], x, last)
    cache = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    cache["len"] = torch.full((tokens.shape[0],), tokens.shape[1],
                              dtype=torch.int32, device=x.device)
    return cache, logits


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: Array) -> Tuple[Array, Dict]:
    """tokens: (B,1). cache leaves carry a leading layer axis."""
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    layer_keys = [k for k in cache if k != "len"]
    for i in range(cfg.num_layers):
        lp = T.layer_params(params, i)
        h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
        out, lc = S.ssm_decode_step(cfg, lp["mixer"], h,
                                    {k: cache[k][i] for k in layer_keys})
        x = x + out
        for k in layer_keys:
            cache[k][i] = lc[k]
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(cfg, params["embed"], x)[:, 0]
    new_cache = {k: cache[k] for k in layer_keys}
    new_cache["len"] = cache["len"] + 1
    return logits, new_cache


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Tuple[Dict, Dict]:
    """TensorSpecs + logical axes for the decode cache (leading layer
    axis).  Constant in ``max_len``."""
    del max_len
    shapes, axes = S.ssm_cache_specs(cfg, batch, torch_dtype(cfg.dtype))
    lshapes = {k: TensorSpec((cfg.num_layers,) + v.shape, v.dtype)
               for k, v in shapes.items()}
    laxes = {k: ("layers",) + v for k, v in axes.items()}
    lshapes["len"] = TensorSpec((batch,), torch.int32)
    laxes["len"] = ("batch",)
    return lshapes, laxes


def init_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    one = S.ssm_cache_init(cfg, batch, torch_dtype(cfg.dtype), device)
    cache = {k: v.expand((cfg.num_layers,) + v.shape).clone()
             for k, v in one.items()}
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache
