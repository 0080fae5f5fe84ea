"""Whisper-style encoder/decoder LM (family "encdec").  Mirrors
``repro.models.encdec``.

The modality frontend (conv-over-mel stack) is a stub, as in ``repro``:
``input_specs()`` supplies precomputed frame embeddings (B, F, D) and the
encoder consumes them directly (zeros when none are given).  The decoder
is a causal LM with a cross-attention sub-layer per block; serving caches
both the decoder self-attention KV *and* the (fixed) encoder cross KV, so
decode steps never re-run the encoder.

Every attention here goes to the flash kernel on the card: the encoder's
non-causal self-attention (S = T = F), the decoder's causal
self-attention in prefill and the first-token ``apply``, and the
non-causal cross-attention (S = the prompt, or 1 in a decode step, over
T = F encoder rows).  The decoder's self-attention in a decode step is
plain PyTorch, as in the transformer.  The layer stacks run as Python
loops over their leading "layers" axis where ``repro`` scans.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import TensorSpec, torch_dtype, tree_map
from repro_torch.models.sharding import use_weight

Array = torch.Tensor


def enc_layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_specs(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_specs(cfg),
    }


def dec_layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "self_attn": L.attention_specs(cfg),
        "lnx": L.rmsnorm_spec(cfg.d_model),
        "cross_attn": L.cross_attention_specs(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_specs(cfg),
    }


def specs(cfg: ModelConfig) -> Dict:
    return {
        "embed": L.embedding_specs(cfg),
        "enc_norm": L.rmsnorm_spec(cfg.d_model),
        "enc_layers": T.stack_specs(enc_layer_specs(cfg), cfg.encoder_layers),
        "layers": T.stack_specs(dec_layer_specs(cfg), cfg.num_layers),
    }


def _layer(stack: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked layer tree (views, no copy)."""
    return tree_map(lambda x: x[i], stack)


def _frames(cfg: ModelConfig, tokens: Array,
            frontend: Optional[Array]) -> Array:
    """The given frame embeddings, or ``repro``'s zeros."""
    if frontend is None:
        frontend = torch.zeros(
            (tokens.shape[0], cfg.num_frontend_tokens, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device=tokens.device)
    return frontend


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _enc_block(cfg: ModelConfig, p: Dict, x: Array) -> Array:
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + L.attention(cfg, p["attn"], h, None, causal=False)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(cfg, p["mlp"], h)


def encode(cfg: ModelConfig, params: Dict, frames: Array) -> Array:
    """frames: (B, F, D) precomputed frame embeddings (frontend stub)."""
    x = frames.to(torch_dtype(cfg.dtype))
    block = T.remat_wrap(cfg, functools.partial(_enc_block, cfg))
    for i in range(cfg.encoder_layers):
        x = block(_layer(params["enc_layers"], i), x)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder training
# ---------------------------------------------------------------------------

def _dec_block(cfg: ModelConfig, p: Dict, x: Array, enc: Array,
               positions: Optional[Array],
               segment_ids: Optional[Array]) -> Array:
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + L.attention(cfg, p["self_attn"], h, positions, segment_ids)
    h = L.rmsnorm(x, p["lnx"], cfg.norm_eps)
    xattn, _ = L.cross_attention(cfg, p["cross_attn"], h, enc)
    x = x + xattn
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(cfg, p["mlp"], h)


def hidden_states(cfg: ModelConfig, params: Dict, batch: Dict
                  ) -> Tuple[Array, Array]:
    """Final-norm decoder hidden states (B,S,D) and a zero aux loss.
    Without ``positions`` in the batch the self-attention takes default
    positions (and so, without ``segment_ids``, the flash kernel)."""
    tokens = batch["tokens"]
    enc = encode(cfg, params, _frames(cfg, tokens, batch.get("frontend")))
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    block = T.remat_wrap(cfg, functools.partial(
        _dec_block, cfg, enc=enc, positions=batch.get("positions"),
        segment_ids=batch.get("segment_ids")))
    for i in range(cfg.num_layers):
        x = block(_layer(params["layers"], i), x)
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
            frontend: Optional[Array] = None,
            last: Optional[Array] = None) -> Tuple[Dict, Array]:
    """Encode frames, prefill the decoder, return (cache, logits (B,V) of
    token position ``last`` (B,), or of the final row when ``last`` is
    None).  Cache: self k/v (L,B,S,Kv,hd), cross k/v (L,B,F,Kv,hd), len
    (B,)."""
    b, s = tokens.shape
    enc = encode(cfg, params, _frames(cfg, tokens, frontend))
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    ks, vs, xks, xvs = [], [], [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, (k, v) = L.attention_prefill(cfg, lp["self_attn"], h)
        x = x + a
        h = L.rmsnorm(x, lp["lnx"], cfg.norm_eps)
        xa, (xk, xv) = L.cross_attention(cfg, lp["cross_attn"], h, enc)
        x = x + xa
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp(cfg, lp["mlp"], h)
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed_row(cfg, params["embed"], x, last)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "xk": torch.stack(xks), "xv": torch.stack(xvs),
             "len": torch.full((b,), s, dtype=torch.int32,
                               device=x.device)}
    return cache, logits


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: Array) -> Tuple[Array, Dict]:
    """One decode step. tokens: (B,1).  The self k/v are written in place
    (the new cache shares them with ``cache``); the cross q is rebuilt
    from ``lnx`` and attends over the cached ``xk``/``xv``."""
    pos = cache["len"]
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    k, v, xk, xv = cache["k"], cache["v"], cache["xk"], cache["xv"]
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = L.attention_decode(cfg, lp["self_attn"], h, pos, k[i],
                                     v[i])
        x = x + a
        h = L.rmsnorm(x, lp["lnx"], cfg.norm_eps)
        xp = lp["cross_attn"]
        q = L.proj_heads(h, xp["wq"], "heads")
        if cfg.qkv_bias:
            q = q + use_weight(xp["bq"], h.dtype)
        x = x + L.cross_attention_apply(cfg, xp, q, xk[i], xv[i])
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp(cfg, lp["mlp"], h)
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(cfg, params["embed"], x)[:, 0]
    return logits, {"k": k, "v": v, "xk": xk, "xv": xv, "len": pos + 1}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Tuple[Dict, Dict]:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    f = cfg.num_frontend_tokens
    lyr = cfg.num_layers
    shapes = {
        "k": TensorSpec((lyr, batch, max_len, kv, hd), dt),
        "v": TensorSpec((lyr, batch, max_len, kv, hd), dt),
        "xk": TensorSpec((lyr, batch, f, kv, hd), dt),
        "xv": TensorSpec((lyr, batch, f, kv, hd), dt),
        "len": TensorSpec((batch,), torch.int32),
    }
    axes = {
        "k": ("layers", "batch", "kv_seq", "kv_heads", None),
        "v": ("layers", "batch", "kv_seq", "kv_heads", None),
        "xk": ("layers", "batch", "frames", "kv_heads", None),
        "xv": ("layers", "batch", "frames", "kv_heads", None),
        "len": ("batch",),
    }
    return shapes, axes
