"""Decoder-only transformer LM (families: dense, moe, vlm).  Mirrors
``repro.models.transformer``.

Layer parameters are stacked along a leading "layers" axis, as in
``repro`` (so ``params_from_numpy`` carries them across unchanged), and
the stack runs as a Python loop over that axis where ``repro`` scans.
Under autograd each layer runs through ``remat_wrap``: ``"full"``
checkpoints it (``repro``'s ``nothing_saveable``), ``"dots"`` saves the
matmul outputs and recomputes the rest (``checkpoint_dots``).  The
training loss never materialises (B, S, V) logits: ``chunked_xent``
recomputes each chunk's in backward.

The moe family puts ``moe.moe_ffn`` in place of the MLP when
``moe_period`` is 1 (``repro``'s rule), ``moe_ep.moe_ffn_ep`` with
``cfg.moe_ep``, and returns the layers' mean auxiliary loss.  The vlm family prepends ``num_frontend_tokens``
precomputed patch embeddings (zeros when none are given, as in
``repro``): they take the first positions, and their rows are trimmed
after the final norm.

A training layer's attention runs in a ``model.attention`` program span
(``core/obs/trace.py``), recorded in the forward only: a checkpoint's
recompute records nothing.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.obs.trace import span
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import moe_ep as MEP
from repro_torch.models.params import (PSpec, TensorSpec, torch_dtype,
                                       tree_map)
from repro_torch.models.sharding import bound_to_ctx, shard

Array = torch.Tensor


FAMILIES = ("dense", "moe", "vlm")


def require_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family} family is not a "
                         f"transformer family {FAMILIES}")


def stack_specs(specs: Any, n: int, axis: str = "layers") -> Any:
    """Prepend a stacked-layer dim to every PSpec leaf."""
    def one(s: PSpec) -> PSpec:
        return PSpec((n,) + s.shape, (axis,) + s.axes, s.init, s.scale,
                     s.dtype)
    return tree_map(one, specs)


# the ops whose outputs "dots" keeps: every matmul and einsum lowers to one
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def remat_wrap(cfg: ModelConfig, fn):
    """``fn`` under the config's rematerialisation policy.  Without grad
    mode there is nothing to save and ``fn`` runs as it is.  A
    checkpointed ``fn`` keeps the sharding context it was wrapped in, for
    its recompute too (``shard`` and ``moe_ep`` read the mesh there)."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS)
    elif cfg.remat != "full":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(bound_to_ctx(fn), *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return wrapped


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i`` of the stacked layer tree (views, no copy)."""
    return tree_map(lambda x: x[i], params["layers"])


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def layer_specs(cfg: ModelConfig) -> Dict:
    require_family(cfg)
    specs = {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_specs(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
    }
    if cfg.num_experts and cfg.moe_period == 1:
        specs["moe"] = M.moe_specs(cfg)
    else:
        specs["mlp"] = L.mlp_specs(cfg)
    return specs


def specs(cfg: ModelConfig) -> Dict:
    return {
        "embed": L.embedding_specs(cfg),
        "layers": stack_specs(layer_specs(cfg), cfg.num_layers),
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ffn(cfg: ModelConfig, p: Dict, h: Array) -> Tuple[Array, Array]:
    """The layer's MoE (expert-parallel with ``moe_ep``) or MLP:
    (output, aux loss)."""
    if "moe" in p:
        ffn = MEP.moe_ffn_ep if cfg.moe_ep else M.moe_ffn
        return ffn(cfg, p["moe"], h)
    return (L.mlp(cfg, p["mlp"], h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _block_train(cfg: ModelConfig, p: Dict, x: Array,
                 positions: Optional[Array],
                 segment_ids: Optional[Array]) -> Tuple[Array, Array]:
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    with span("model.attention"):
        a = L.attention(cfg, p["attn"], h, positions, segment_ids)
    x = shard(x + a, "batch", "seq", None)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    f, aux = _ffn(cfg, p, h)
    x = x + f
    return shard(x, "batch", "seq", None), aux


def _forward(cfg: ModelConfig, params: Dict, x: Array,
             positions: Optional[Array],
             segment_ids: Optional[Array]) -> Tuple[Array, Array]:
    """Run the layer stack. Returns (hidden, mean aux loss)."""
    block = remat_wrap(cfg, functools.partial(
        _block_train, cfg, positions=positions, segment_ids=segment_ids))
    auxs = []
    for i in range(cfg.num_layers):
        x, aux = block(layer_params(params, i), x)
        auxs.append(aux)
    return x, torch.stack(auxs).mean()


def _default_frontend(cfg: ModelConfig, tokens: Array,
                      frontend: Optional[Array]) -> Optional[Array]:
    """The vlm family's zero patch embeddings when none are given."""
    if frontend is None and cfg.num_frontend_tokens and cfg.family == "vlm":
        frontend = torch.zeros(
            (tokens.shape[0], cfg.num_frontend_tokens, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device=tokens.device)
    return frontend


def _inputs_embed(cfg: ModelConfig, params: Dict, tokens: Array,
                  frontend: Optional[Array]) -> Array:
    """Token embedding, after the frontend stub's rows if there is one.
    The positions are arange over both (``None`` downstream)."""
    dtype = torch_dtype(cfg.dtype)
    x = L.embed(params["embed"], tokens, dtype)
    if frontend is not None:
        x = torch.cat([frontend.to(dtype), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def apply(cfg: ModelConfig, params: Dict, batch: Dict) -> Tuple[Array, Array]:
    """Forward returning full float32 logits (B,S,V)."""
    x, aux = hidden_states(cfg, params, batch)
    return L.unembed(cfg, params["embed"], x), aux


def hidden_states(cfg: ModelConfig, params: Dict, batch: Dict
                  ) -> Tuple[Array, Array]:
    """Final-norm hidden states over the *token* positions (frontend stub
    positions trimmed). Returns (x (B,S,D), aux).  Without ``positions``
    in the batch the attention takes default positions (and so, without
    ``segment_ids``, the flash kernel)."""
    tokens = batch["tokens"]
    frontend = _default_frontend(cfg, tokens, batch.get("frontend"))
    x = _inputs_embed(cfg, params, tokens, frontend)
    nf = 0 if frontend is None else frontend.shape[1]
    positions = batch.get("positions")
    segment_ids = batch.get("segment_ids")
    if positions is not None and nf:
        b = x.shape[0]
        fpos = torch.arange(nf, dtype=positions.dtype,
                            device=x.device).expand(b, nf)
        positions = torch.cat([fpos, positions + nf], dim=1)
        if segment_ids is not None:
            fseg = torch.ones((b, nf), dtype=segment_ids.dtype,
                              device=x.device)
            segment_ids = torch.cat([fseg, segment_ids], dim=1)
    x, aux = _forward(cfg, params, x, positions, segment_ids)
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    if nf:
        x = x[:, nf:]
    return x, aux


def loss(cfg: ModelConfig, params: Dict, batch: Dict,
         aux_weight: float = 0.01) -> Tuple[Array, Dict]:
    """Training loss.  The hidden states are unembedded in sequence chunks
    (recomputed in the backward pass), so the (B,S,V) logits never
    exist at once."""
    hidden, aux = hidden_states(cfg, params, batch)
    ce, denom = chunked_xent(cfg, params["embed"], hidden,
                             batch["targets"], batch.get("loss_mask"))
    total = ce + aux_weight * aux
    return total, {"loss": ce, "aux": aux, "tokens": denom}


def _xent_sum(cfg: ModelConfig, embed_params: Dict, hidden: Array,
              targets: Array, mask: Array) -> Tuple[Array, Array]:
    """(sum of the masked float32 NLL, sum of the mask) of one chunk."""
    logits = L.unembed(cfg, embed_params, hidden)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


def chunked_xent(cfg: ModelConfig, embed_params: Dict, hidden: Array,
                 targets: Array, mask: Optional[Array],
                 chunk: int = 512) -> Tuple[Array, Array]:
    """Mean cross-entropy over the mask and its denominator max(sum of
    the mask, 1).  A sequence of more than one ``chunk`` that divides it
    is unembedded chunk by chunk, each chunk checkpointed under autograd
    so backward recomputes its float32 logits."""
    b, s, _ = hidden.shape
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    mask = mask.float()
    if s % chunk != 0 or s <= chunk:
        tot, cnt = _xent_sum(cfg, embed_params, hidden, targets, mask)
        denom = torch.clamp(cnt, min=1.0)
        return tot / denom, denom
    fn = functools.partial(_xent_sum, cfg, embed_params)
    if torch.is_grad_enabled():
        fn = functools.partial(checkpoint, fn, use_reentrant=False,
                               preserve_rng_state=False)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        a, n = fn(hidden[:, sl], targets[:, sl], mask[:, sl])
        tot, cnt = tot + a, cnt + n
    denom = torch.clamp(cnt, min=1.0)
    return tot / denom, denom


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _block_prefill(cfg, p, x):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, kv = L.attention_prefill(cfg, p["attn"], h)
    x = x + a
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, p, h)[0], kv


def prefill(cfg: ModelConfig, params: Dict, tokens: Array,
            frontend: Optional[Array] = None,
            last: Optional[Array] = None) -> Tuple[Dict, Array]:
    """Returns (cache {k,v:(L,B,S,Kv,hd), len:(B,)}, logits (B,V)).  The
    logits are those of token position ``last`` (B,), counted over the
    tokens alone, or of the final row when ``last`` is None.  S and
    ``len`` count the frontend stub's rows too."""
    frontend = _default_frontend(cfg, tokens, frontend)
    if last is not None and frontend is not None:
        last = last + frontend.shape[1]
    x = _inputs_embed(cfg, params, tokens, frontend)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _block_prefill(cfg, layer_params(params, i), x)
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed_row(cfg, params["embed"], x, last)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "len": torch.full((tokens.shape[0],), x.shape[1],
                               dtype=torch.int32, device=x.device)}
    return cache, logits


def _block_decode(cfg, p, x, pos, k_cache, v_cache):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, k_cache, v_cache = L.attention_decode(
        cfg, p["attn"], h, pos, k_cache, v_cache)
    x = x + a
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, p, h)[0], k_cache, v_cache


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: Array) -> Tuple[Array, Dict]:
    """One decode step. tokens: (B,1); cache k/v: (L,B,Smax,Kv,hd).
    Returns (logits (B,V), new cache).  The k/v tensors are written in
    place: the new cache shares them with ``cache``."""
    pos = cache["len"]                                    # (B,)
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    k, v = cache["k"], cache["v"]
    for i in range(cfg.num_layers):
        x, _, _ = _block_decode(cfg, layer_params(params, i), x, pos, k[i],
                                v[i])
    x = L.rmsnorm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(cfg, params["embed"], x)[:, 0]
    return logits, {"k": k, "v": v, "len": pos + 1}


def kv_cache_specs(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Tuple[Dict, Dict]:
    """TensorSpecs + logical axes for a decode cache."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    shapes = {
        "k": TensorSpec((cfg.num_layers, batch, max_len, kv, hd), dt),
        "v": TensorSpec((cfg.num_layers, batch, max_len, kv, hd), dt),
        "len": TensorSpec((batch,), torch.int32),
    }
    axes = {
        "k": ("layers", "batch", "kv_seq", "kv_heads", None),
        "v": ("layers", "batch", "kv_seq", "kv_heads", None),
        "len": ("batch",),
    }
    return shapes, axes
