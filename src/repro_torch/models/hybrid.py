"""Jamba-style hybrid LM (family "hybrid"): periods of ``attn_period``
sub-layers with one attention sub-layer per period (index
``attn_offset``) and Mamba2 mixers elsewhere; the FFN alternates dense
MLP / MoE by ``moe_period``.  Mirrors ``repro.models.hybrid``.

Parameters are stacked per period (``periods`` -> ``sub<i>`` -> ...), and
the periods run as a Python loop where ``repro`` scans.  The decode cache
holds k and v per period for the attention sub-layer and an O(1) SSD
cache per Mamba sub-layer, ``"ssm": {"sub<i>": {...}}``;
``decode_step`` writes it in place.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import moe_ep as MEP
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.params import TensorSpec, torch_dtype, tree_map
from repro_torch.models.sharding import shard

Array = torch.Tensor


def _is_attn(cfg: ModelConfig, i: int) -> bool:
    return (i % cfg.attn_period) == cfg.attn_offset


def _is_moe(cfg: ModelConfig, i: int) -> bool:
    return bool(cfg.num_experts) and (i % cfg.moe_period) == cfg.moe_offset


def num_periods(cfg: ModelConfig) -> int:
    assert cfg.num_layers % cfg.attn_period == 0, (
        "hybrid num_layers must be a multiple of attn_period")
    return cfg.num_layers // cfg.attn_period


def period_specs(cfg: ModelConfig) -> Dict:
    subs = {}
    for i in range(cfg.attn_period):
        subs[f"sub{i}"] = {
            "ln1": L.rmsnorm_spec(cfg.d_model),
            "ln2": L.rmsnorm_spec(cfg.d_model),
            "mixer": (L.attention_specs(cfg) if _is_attn(cfg, i)
                      else S.ssm_specs(cfg)),
            "ffn": (M.moe_specs(cfg) if _is_moe(cfg, i)
                    else L.mlp_specs(cfg)),
        }
    return subs


def specs(cfg: ModelConfig) -> Dict:
    return {
        "embed": L.embedding_specs(cfg),
        "periods": T.stack_specs(period_specs(cfg), num_periods(cfg),
                                 axis="periods"),
    }


def _period_params(params: Dict, j: int) -> Dict:
    return tree_map(lambda x: x[j], params["periods"])


def _ffn(cfg: ModelConfig, i: int, p: Dict, h: Array) -> Tuple[Array, Array]:
    """Sub-layer i's MoE or MLP: (output, aux loss)."""
    if _is_moe(cfg, i):
        ffn = MEP.moe_ffn_ep if cfg.moe_ep else M.moe_ffn
        return ffn(cfg, p["ffn"], h)
    return (L.mlp(cfg, p["ffn"], h),
            torch.zeros((), dtype=torch.float32, device=h.device))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _period_fwd(cfg: ModelConfig, pp: Dict, x: Array,
                positions: Optional[Array],
                segment_ids: Optional[Array]) -> Tuple[Array, Array]:
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.attn_period):
        p = pp[f"sub{i}"]
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        if _is_attn(cfg, i):
            mix = L.attention(cfg, p["mixer"], h, positions, segment_ids)
        else:
            mix = S.ssm_block(cfg, p["mixer"], h)
        x = x + mix
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        f, aux = _ffn(cfg, i, p, h)
        aux_total = aux_total + aux
        x = x + f
        x = shard(x, "batch", "seq", None)
    return x, aux_total


def hidden_states(cfg: ModelConfig, params: Dict, batch: Dict
                  ) -> Tuple[Array, Array]:
    """Without ``positions`` in the batch the attention sub-layers take
    default positions (and so, without ``segment_ids``, the flash
    kernel)."""
    x = L.embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
    body = T.remat_wrap(cfg, functools.partial(
        _period_fwd, cfg, positions=batch.get("positions"),
        segment_ids=batch.get("segment_ids")))
    auxs = []
    for j in range(num_periods(cfg)):
        x, aux = body(_period_params(params, j), x)
        auxs.append(aux)
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    return x, torch.stack(auxs).mean()


def apply(cfg: ModelConfig, params: Dict, batch: Dict) -> Tuple[Array, Array]:
    x, aux = hidden_states(cfg, params, batch)
    return L.unembed(cfg, params["embed"], x), aux


def loss(cfg: ModelConfig, params: Dict, batch: Dict,
         aux_weight: float = 0.01) -> Tuple[Array, Dict]:
    x, aux = hidden_states(cfg, params, batch)
    ce, denom = T.chunked_xent(cfg, params["embed"], x,
                               batch["targets"], batch.get("loss_mask"))
    total = ce + aux_weight * aux
    return total, {"loss": ce, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _mamba_subs(cfg: ModelConfig) -> List[int]:
    return [i for i in range(cfg.attn_period) if not _is_attn(cfg, i)]


def prefill(cfg: ModelConfig, params: Dict, tokens: Array,
            frontend=None, last=None) -> Tuple[Dict, Array]:
    """Returns (cache, logits (B,V) of token position ``last`` (B,), or of
    the final row when ``last`` is None)."""
    del frontend
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    ks, vs, ssm = [], [], {f"sub{i}": [] for i in _mamba_subs(cfg)}
    for j in range(num_periods(cfg)):
        pp = _period_params(params, j)
        for i in range(cfg.attn_period):
            p = pp[f"sub{i}"]
            h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
            if _is_attn(cfg, i):
                mix, (k, v) = L.attention_prefill(cfg, p["mixer"], h)
                ks.append(k)
                vs.append(v)
            else:
                mix, c = S.ssm_block(cfg, p["mixer"], h, return_cache=True)
                ssm[f"sub{i}"].append(c)
            x = x + mix
            h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + _ffn(cfg, i, p, h)[0]
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed_row(cfg, params["embed"], x, last)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "ssm": {name: {k: torch.stack([c[k] for c in cs])
                            for k in cs[0]} for name, cs in ssm.items()},
             "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return cache, logits


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: Array) -> Tuple[Array, Dict]:
    """One decode step; the cache's tensors are written in place."""
    pos = cache["len"]
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    for j in range(num_periods(cfg)):
        pp = _period_params(params, j)
        for i in range(cfg.attn_period):
            p = pp[f"sub{i}"]
            h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
            if _is_attn(cfg, i):
                mix, _, _ = L.attention_decode(cfg, p["mixer"], h, pos,
                                               cache["k"][j], cache["v"][j])
            else:
                sc = cache["ssm"][f"sub{i}"]
                mix, new = S.ssm_decode_step(
                    cfg, p["mixer"], h, {k: v[j] for k, v in sc.items()})
                for k, v in new.items():
                    sc[k][j] = v
            x = x + mix
            h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + _ffn(cfg, i, p, h)[0]
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(cfg, params["embed"], x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "ssm": cache["ssm"],
                    "len": pos + 1}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Tuple[Dict, Dict]:
    np_ = num_periods(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    sshapes, saxes = S.ssm_cache_specs(cfg, batch, dt)
    shapes = {
        "k": TensorSpec((np_, batch, max_len, kv, hd), dt),
        "v": TensorSpec((np_, batch, max_len, kv, hd), dt),
        "ssm": {f"sub{i}": {
            k_: TensorSpec((np_,) + v_.shape, v_.dtype)
            for k_, v_ in sshapes.items()} for i in _mamba_subs(cfg)},
        "len": TensorSpec((batch,), torch.int32),
    }
    axes = {
        "k": ("periods", "batch", "kv_seq", "kv_heads", None),
        "v": ("periods", "batch", "kv_seq", "kv_heads", None),
        "ssm": {f"sub{i}": {k_: ("periods",) + v_ for k_, v_ in saxes.items()}
                for i in _mamba_subs(cfg)},
        "len": ("batch",),
    }
    return shapes, axes
