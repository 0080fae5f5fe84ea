"""Common transformer layers: RMSNorm, RoPE, GQA attention (full
sequence, causal or not / prefill / decode with per-example cache
positions), encoder-decoder cross attention, the SwiGLU and gelu MLPs,
embedding.  Mirrors ``repro.models.layers``; tensors keep its layouts
((B, S, H, D) activations, (B, Smax, Kv, D) caches).

Attention without segment ids over default positions (``positions`` is
``None``: arange from 0 on both sides) is what the flash kernel computes,
with S <= T when causal.  ``_sdpa`` sends those calls to
``kernels.flash_attention.ops`` (the hand kernel for CUDA tensors, its
plain version elsewhere) unless autograd needs their gradient: the kernel
is forward-only, as ``repro``'s Pallas kernel is.  Every other call
(packed segments, explicit positions, training) runs ``repro``'s XLA
path: ``_chunked_gqa``, an online-softmax scan over blocks of up to 1,024
queries and keys, or the materialised softmax when a length has no such
block.  On the card those are recorded in
``repro_torch.kernels.path_stats()`` as ("flash_attention",
"plain_on_card").
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import note_path, on_cuda
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.params import PSpec
from repro_torch.models.sharding import (constrain, grad_onto_own_placements,
                                         heads_where_free, matmul_rows,
                                         on_own_rows, product_operands,
                                         shard, softmax_last, use_weight,
                                         whole_where)

Array = torch.Tensor

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free
                 # for fully-masked rows (padding slots in packed batches)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: Array, w: Array, eps: float) -> Array:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * use_weight(w, dt)


def rmsnorm_spec(d: int) -> PSpec:
    return PSpec((d,), ("embed",), init="ones", dtype="float32")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def default_positions(b: int, s: int, device) -> Array:
    """(B, S) int32 arange: what ``positions=None`` stands for."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def rope(x: Array, positions: Array, theta: float) -> Array:
    """Rotate-half RoPE.  x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta) *
                     torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = positions.float()[..., None] * freq                   # (..., S, half)
    sin = torch.sin(ang)[..., None, :]                          # (..., S, 1, half)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rest = x[..., 2 * half:]
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), rest], dim=-1)


# ---------------------------------------------------------------------------
# attention parameter specs
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig, d_in: Optional[int] = None) -> Dict:
    d = d_in or cfg.d_model
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    specs = {
        "wq": PSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = PSpec((h, hd), ("heads", "head_dim"), init="zeros")
        specs["bk"] = PSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = PSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return specs


def proj_heads(x: Array, w: Array, heads: str) -> Array:
    """x (B,S,D) times a (D,H,hd) weight, ``einsum("bsd,dhk->bshk")`` as
    one matmul over the flattened (H·hd), both placed for it
    (``product_operands``: the contraction split where the heads are
    whole over "model"), the Partial sum reduced onto the ``heads``
    rule."""
    b, s, _ = x.shape
    d, h, hd = w.shape
    x, w = product_operands(x, w.reshape(d, h * hd), x.dtype, ((0, -1),))
    y = matmul_rows(x, w).reshape(b, s, h, hd)
    return constrain(y, "batch", "act_seq", heads, None)


def _proj_out(out: Array, w: Array, dtype: torch.dtype) -> Array:
    """The output projection of (B,S,H,hd) heads,
    ``einsum("bshk,hkd->bsd")`` as one matmul over the flattened (H·hd),
    each rank's rows, the Partial sum over the heads reduced."""
    b, s, h, hd = out.shape
    out, w = product_operands(out.reshape(b, s, h * hd),
                              w.reshape(h * hd, -1), dtype, ((0, -1),))
    return constrain(matmul_rows(out, w), "batch", "seq", None)


def _qkv(cfg: ModelConfig, p: Dict, x: Array) -> Tuple[Array, Array, Array]:
    q = proj_heads(x, p["wq"], "heads")
    k = proj_heads(x, p["wk"], "kv_heads")
    v = proj_heads(x, p["wv"], "kv_heads")
    if cfg.qkv_bias:
        q = q + use_weight(p["bq"], x.dtype)
        k = k + use_weight(p["bk"], x.dtype)
        v = v + use_weight(p["bv"], x.dtype)
    return q, k, v


def _gqa_scores(q: Array, k: Array, q_per_kv: int) -> Array:
    """q: (B,S,H,D) -> grouped (B,Kv,G,S,D); k: (B,T,Kv,D).
    Returns fp32 scores (B,Kv,G,S,T) (bf16 inputs widen exactly)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, s, kvh, q_per_kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    return scores * (d ** -0.5)


def _gqa_out(probs: Array, v: Array) -> Array:
    """probs: (B,Kv,G,S,T); v: (B,T,Kv,D) -> (B,S,H,D)."""
    b, kvh, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, kvh * g, v.shape[-1])


def causal_mask(positions_q: Array, positions_k: Array,
                seg_q: Optional[Array], seg_k: Optional[Array]) -> Array:
    """(B,S,T) boolean mask: causal in *positions* and packing-aware."""
    m = positions_q[:, :, None] >= positions_k[:, None, :]
    if seg_q is not None:
        m = m & (seg_q[:, :, None] == seg_k[:, None, :])
    return m


def _pick_block(s: int, cap: int = 1024) -> Optional[int]:
    for b in (1024, 512, 256, 128):
        if b <= cap and s % b == 0 and s > b:
            return b
    return None


def _sdpa(cfg: ModelConfig, q: Array, k: Array, v: Array,
          pos_q: Optional[Array], pos_k: Optional[Array],
          seg_q: Optional[Array], seg_k: Optional[Array],
          causal: bool) -> Array:
    """Scaled-dot-product GQA attention.  Returns (B,S,H,D).

    ``pos_q``/``pos_k`` of ``None`` are default positions (arange from 0).
    With default positions, no segment ids, S <= T when causal and no
    gradient to carry, this is flash attention (top-left causal mask):
    the kernel on the card, its plain version elsewhere.  Anything else
    takes ``repro``'s choice: ``_chunked_gqa`` when both lengths have a
    block, else the materialised masked softmax; on the card it is
    recorded as "plain_on_card".

    On DTensors whose rows and heads each rank can attend over alone
    (``on_own_rows``), it runs on the local shards and hands back q's
    placements: no rank repeats another's heads."""
    own = on_own_rows(lambda *a: (_sdpa(cfg, *a, causal),),
                      (q, k, v, pos_q, pos_k, seg_q, seg_k),
                      ((0, 2),) * 3 + ((0, None),) * 4, ((0, 2),),
                      trade_heads=False)
    if own is not None:
        return own[0]
    s, t = q.shape[1], k.shape[1]
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if (not needs_grad and pos_q is None and pos_k is None
            and seg_q is None and seg_k is None and (not causal or s <= t)):
        return fa_ops.flash_attention(q, k, v, causal)
    note_path("flash_attention",
              "plain_on_card" if on_cuda(q) else "reference")
    b = q.shape[0]
    if pos_q is None:
        pos_q = default_positions(b, s, q.device)
    if pos_k is None:
        pos_k = default_positions(b, t, k.device)
    qb, kb = _pick_block(s), _pick_block(t)
    if qb is None or kb is None:
        scores = _gqa_scores(q, k, cfg.q_per_kv)      # (B,Kv,G,S,T) fp32
        if causal or seg_q is not None:
            m = causal_mask(pos_q, pos_k, seg_q, seg_k) if causal else (
                seg_q[:, :, None] == seg_k[:, None, :])
            scores = torch.where(m[:, None, None], scores, NEG_INF)
        return _gqa_out(torch.softmax(scores, dim=-1), v)
    return _chunked_gqa(cfg, q, k, v, pos_q, pos_k, seg_q, seg_k, qb, kb,
                        causal)


def _kv_step(qb: Array, kb: Array, vb: Array, mask: Optional[Array],
             o: Array, m: Array, l: Array) -> Tuple[Array, Array, Array]:
    """One key/value block of the online softmax.  qb: (B,Qb,Kv,G,D);
    kb, vb: (B,Tb,Kv,D); mask: (B,Qb,Tb) or None; o: (B,Kv,G,Qb,D), m, l:
    (B,Kv,G,Qb), all float32.  A block whose keys are all masked gives
    p = 1 (NEG_INF - NEG_INF = 0) until a later block's alpha = 0 wipes
    it, as in ``repro``; -inf would make that NaN."""
    scale = qb.shape[-1] ** -0.5
    sblk = torch.einsum("bqkgd,btkd->bkgqt", qb.float(), kb.float()) * scale
    if mask is not None:
        sblk = torch.where(mask[:, None, None], sblk, NEG_INF)
    m_new = torch.maximum(m, sblk.amax(dim=-1))
    p = torch.exp(sblk - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bkgqt,btkd->bkgqd", p, vb.float())
    return o * alpha[..., None] + pv, m_new, l


def _chunked_gqa(cfg: ModelConfig, q: Array, k: Array, v: Array,
                 pos_q: Array, pos_k: Array,
                 seg_q: Optional[Array], seg_k: Optional[Array],
                 q_block: int, kv_block: int, causal: bool) -> Array:
    """Online-softmax (flash-style) attention in plain PyTorch, ``repro``'s
    double scan over query and key/value blocks with running (m, l, o)
    statistics in float32, as loops.  Under autograd each key/value step
    is checkpointed: backward keeps its carry, not its (B,Kv,G,Qb,Tb)
    score blocks, and recomputes them one step at a time."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    nq, nk = s // q_block, t // kv_block
    qx = q.reshape(b, nq, q_block, kvh, g, d)
    kx = k.reshape(b, nk, kv_block, kvh, d)
    vx = v.reshape(b, nk, kv_block, kvh, d)
    pqx, pkx = pos_q.reshape(b, nq, q_block), pos_k.reshape(b, nk, kv_block)
    has_seg = seg_q is not None
    if has_seg:
        sqx = seg_q.reshape(b, nq, q_block)
        skx = seg_k.reshape(b, nk, kv_block)
    step = _kv_step
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, _kv_step, use_reentrant=False,
                                 preserve_rng_state=False)
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    for i in range(nq):
        o = torch.zeros((b, kvh, g, q_block, d), **f32)
        m = torch.full((b, kvh, g, q_block), NEG_INF, **f32)
        l = torch.zeros((b, kvh, g, q_block), **f32)
        for j in range(nk):
            mask = None
            if causal:
                mask = pqx[:, i, :, None] >= pkx[:, j, None, :]
            if has_seg:
                segm = sqx[:, i, :, None] == skx[:, j, None, :]
                mask = segm if mask is None else (mask & segm)
            o, m, l = step(qx[:, i], kx[:, j], vx[:, j], mask, o, m, l)
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    # (nq, B, Kv, G, Qb, D) -> (B, S, H, D)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, d)
    return out.to(v.dtype)


def attention(cfg: ModelConfig, p: Dict, x: Array,
              positions: Optional[Array],
              segment_ids: Optional[Array] = None,
              causal: bool = True) -> Array:
    """Full-sequence attention (train / encoder). x: (B,S,D);
    ``positions`` None means arange from 0."""
    q, k, v = _qkv(cfg, p, x)
    pos = positions if positions is not None else default_positions(
        x.shape[0], x.shape[1], x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    q = shard(q, "batch", "act_seq", "heads", None)
    k = shard(k, "batch", "act_seq", "kv_heads", None)
    v = shard(v, "batch", "act_seq", "kv_heads", None)
    out = _sdpa(cfg, q, k, v, positions, positions,
                segment_ids, segment_ids, causal)
    out = shard(out, "batch", "act_seq", "heads", None)
    return _proj_out(out, p["wo"], x.dtype)


def attention_prefill(cfg: ModelConfig, p: Dict, x: Array
                      ) -> Tuple[Array, Tuple[Array, Array]]:
    """Like ``attention`` over default positions, also returning (k, v)
    for cache construction."""
    q, k, v = _qkv(cfg, p, x)
    pos = default_positions(x.shape[0], x.shape[1], x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    k = shard(k, "batch", "kv_seq", "kv_heads", None)
    v = shard(v, "batch", "kv_seq", "kv_heads", None)
    out = _sdpa(cfg, q, k, v, None, None, None, None, True)
    return _proj_out(out, p["wo"], x.dtype), (k, v)


def cross_attention_specs(cfg: ModelConfig) -> Dict:
    return attention_specs(cfg)


def cross_attention(cfg: ModelConfig, p: Dict, x: Array, enc: Array
                    ) -> Tuple[Array, Tuple[Array, Array]]:
    """Encoder-decoder cross attention (no RoPE, no mask). x: (B,S,D),
    enc: (B,F,D). Returns (out, (k,v)) so serving can cache encoder KV."""
    q = proj_heads(x, p["wq"], "heads")
    k = proj_heads(enc, p["wk"], "kv_heads")
    v = proj_heads(enc, p["wv"], "kv_heads")
    if cfg.qkv_bias:
        q = q + use_weight(p["bq"], x.dtype)
        k = k + use_weight(p["bk"], enc.dtype)
        v = v + use_weight(p["bv"], enc.dtype)
    y = cross_attention_apply(cfg, p, q, k, v)
    return y, (k, v)


def cross_attention_apply(cfg: ModelConfig, p: Dict, q: Array,
                          k: Array, v: Array) -> Array:
    """Non-causal attention of q (B,S,H,D) over the encoder's k, v
    (B,F,Kv,D).  ``repro`` passes arange positions on both sides, which
    a non-causal, segment-free attention never reads; the port passes
    ``None`` (the same thing) so that ``_sdpa`` takes the flash kernel."""
    out = _sdpa(cfg, q, k, v, None, None, None, None, causal=False)
    return _proj_out(out, p["wo"], q.dtype)


def cache_update(k_cache: Array, v_cache: Array, k_new: Array, v_new: Array,
                 pos: Array) -> Tuple[Array, Array]:
    """Write one new token per example at per-example positions, IN PLACE
    (``repro`` returns new arrays; the port saves the copy).  caches:
    (B, Smax, Kv, D); new: (B, 1, Kv, D); pos: (B,) int32.  A position
    past the end writes the last slot, as ``dynamic_update_slice``
    clamps its start."""
    if type(k_cache) not in (torch.Tensor, torch.nn.Parameter):
        from torch.distributed.tensor import DTensor
        if isinstance(k_cache, DTensor):
            _sharded_cache_write(k_cache, k_new, pos)
            _sharded_cache_write(v_cache, v_new, pos)
            return k_cache, v_cache
    b, smax = k_cache.shape[:2]
    rows = torch.arange(b, device=k_cache.device)
    at = pos.long().clamp(0, smax - 1)
    k_cache[rows, at] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, at] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def _sharded_cache_write(cache, new, pos) -> None:
    """``cache_update``'s write into a DTensor cache (B, Smax, Kv, D)
    sharded over the batch and the sequence (``repro``'s decode rules
    shard "kv_seq"), in place on each rank's shard: DTensor has no
    strategy for an in-place ``index_put_`` into sharded dimensions, which
    GSPMD partitions as a dynamic-update-slice.  The new rows and the
    positions are redistributed to the cache's batch sharding (replicated
    over the sequence's mesh dimensions), and the rank whose slice of the
    sequence holds a row's position writes it."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = cache.device_mesh, cache.placements
    coord = mesh.get_coordinate()
    smax = cache.shape[1]
    ranks, index = 1, 0       # over the sequence: this rank's slice of it
    for m, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            ranks, index = ranks * mesh.size(m), index * mesh.size(m) \
                + coord[m]
    same = [p if isinstance(p, Shard) and p.dim != 1 else Replicate()
            for p in pl]
    rows_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in pl]
    new_l = new.redistribute(mesh, same).to_local()[:, 0].to(cache.dtype)
    pos_l = pos.redistribute(mesh, rows_pl).to_local()
    local = cache.to_local()
    seq_l = smax // ranks
    at = pos_l.long().clamp(0, smax - 1) - index * seq_l
    own = (at >= 0) & (at < seq_l)
    at = at.clamp(0, seq_l - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    keep = local[rows, at]
    local[rows, at] = torch.where(own.view(-1, *([1] * (keep.dim() - 1))),
                                  new_l, keep)


def attention_decode(cfg: ModelConfig, p: Dict, x: Array, pos: Array,
                     k_cache: Array, v_cache: Array,
                     ) -> Tuple[Array, Array, Array]:
    """Single-token decode. x: (B,1,D); pos: (B,) current position;
    caches: (B,Smax,Kv,D), updated in place. Returns (out, k_cache,
    v_cache).  Plain PyTorch, as in ``repro``: no kernel."""
    smax = k_cache.shape[1]
    q, k_new, v_new = _qkv(cfg, p, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)
    k_cache, v_cache = cache_update(k_cache, v_cache, k_new, v_new, pos)
    # the cache's sequence stays put; free mesh dimensions split heads
    q, kc, vc = heads_where_free(whole_where(q, k_cache, 1), k_cache,
                                 v_cache)
    scores = _gqa_scores(q, kc, cfg.q_per_kv)         # (B,Kv,G,1,Smax)
    valid = (torch.arange(smax, device=x.device)[None]
             <= pos[:, None])                          # (B,Smax)
    scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = softmax_last(scores)
    out = _gqa_out(probs, vc)                         # (B,1,H,D)
    out = constrain(out, "batch", "act_seq", "heads", None)
    return _proj_out(out, p["wo"], x.dtype), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    """SwiGLU (the dense family's), or whisper's biased gelu MLP."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_variant == "swiglu":
        return {
            "w_gate": PSpec((d, f), ("embed", "ffn")),
            "w_up": PSpec((d, f), ("embed", "ffn")),
            "w_down": PSpec((f, d), ("ffn", "embed")),
        }
    return {
        "w_in": PSpec((d, f), ("embed", "ffn")),
        "b_in": PSpec((f,), ("ffn",), init="zeros"),
        "w_out": PSpec((f, d), ("ffn", "embed")),
        "b_out": PSpec((d,), ("embed",), init="zeros"),
    }


def mlp(cfg: ModelConfig, p: Dict, x: Array) -> Array:
    """Each weight placed for its product (``use_weight``), the
    products' Partial sums reduced by the ``shard`` after them."""
    dt = x.dtype

    def product(h, name, *out):
        h, w = product_operands(h, p[name], dt, ((0, -1),))
        return constrain(matmul_rows(h, w), *out)

    def up(name):
        return product(x, name, "batch", "act_seq", "ffn")

    def down(h, name):
        return product(h, name, "batch", "seq", None)

    if cfg.mlp_variant == "swiglu":
        h = torch.nn.functional.silu(up("w_gate")) * up("w_up")
        h = shard(h, "batch", "act_seq", "ffn")
        return down(h, "w_down")
    # jax.nn.gelu's default is the tanh approximation
    h = torch.nn.functional.gelu(up("w_in") + use_weight(p["b_in"], dt),
                                 approximate="tanh")
    h = shard(h, "batch", "act_seq", "ffn")
    return down(h, "w_out") + use_weight(p["b_out"], dt)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_specs(cfg: ModelConfig) -> Dict:
    specs = {
        "tok": PSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                     init="embed"),
        "norm_f": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["head"] = PSpec((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), init="embed")
    return specs


def embed(p: Dict, tokens: Array, dtype: torch.dtype) -> Array:
    """The table's rows of ``tokens``, sharded over the batch.  Tokens
    that are a DTensor (the trainer's production layout) are gathered
    whole first: the read's backward, an accumulating ``index_put``, has
    no strategy for batch-sharded indices on torch 2.11, and over whole
    indices it is every rank's own; ``shard`` then takes each rank's
    rows again.  The values are the plain gather's.  The table's
    gradient from this read lands on the table's placements
    (``grad_onto_own_placements``: a tied head adds its own there)."""
    if hasattr(tokens, "full_tensor"):
        from torch.distributed.tensor import Replicate
        tokens = tokens.redistribute(
            tokens.device_mesh, [Replicate()] * tokens.device_mesh.ndim)
    x = grad_onto_own_placements(p["tok"])[tokens.long()].to(dtype)
    return shard(x, "batch", "seq", None)


def unembed(cfg: ModelConfig, p: Dict, x: Array) -> Array:
    """Float32 logits (B,S,V): the head in x's dtype, widened exactly, so
    the products accumulate in float32 and are never rounded to bf16.
    Where the vocabulary does not divide over "model", the head splits
    its contraction there instead (``use_weight``), and the Partial sum
    is reduced before the softcap."""
    x, w = product_operands(x, grad_onto_own_placements(
        p.get("head", p["tok"])), x.dtype, ((1, -1),))
    logits = shard(matmul_rows(x.float(), w.float().t()),
                   "batch", "logits_seq", "vocab")
    if cfg.logits_softcap > 0:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def unembed_row(cfg: ModelConfig, p: Dict, x: Array,
                last: Optional[Array] = None) -> Array:
    """Float32 logits (B,V) of one row of each sequence of x (B,S,D): row
    ``last`` (B,) where it is given (one gather), else the final row;
    ``unembed`` of that row alone."""
    if last is None:
        row = x[:, -1:]
    else:
        idx = last.to(device=x.device, dtype=torch.long)
        row = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))
    return unembed(cfg, p, row)[:, 0]
