"""Mamba-2 (SSD, state-space duality) mixer.  Mirrors ``repro.models.ssm``.

Prefill runs the chunked SSD algorithm: within a chunk a masked,
decay-weighted attention-like product, and across chunks a small state
recurrence (B, H, P, N) in float32, a loop over chunks where ``repro``
scans.  Decode is the O(1) recurrent step on the same state.

What is copied on purpose, because it decides the numbers:
  * the chunk is ``min(ssm_chunk, S)`` and S must be a multiple of it
    (``repro`` asserts; nothing is padded);
  * the intra-chunk decay is ``repro``'s ``where(tri, exp(diff), 0)``
    in float32, computed as ``exp(where(tri, diff, -inf))``: the same
    values, and a finite gradient where ``repro``'s is 0 · inf = NaN
    (above the diagonal ``diff`` overflows ``exp`` at mamba2's chunk of
    256; ROADMAP Queue 3);
  * the causal conv adds one tap at a time in the activation dtype,
    rounding after each (it is not ``conv1d``, which sums in float32);
  * the D skip is added in the activation dtype in prefill and in
    float32 in decode;
  * prefill's cache keeps the last W-1 raw (pre-conv) inputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import PSpec, TensorSpec
from repro_torch.models.sharding import (constrain, matmul_rows,
                                         on_local_shards, on_own_rows,
                                         placed_as, product_operands, shard,
                                         use_weight)

Array = torch.Tensor


def ssm_specs(cfg: ModelConfig) -> Dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv
    return {
        "w_z": PSpec((d, di), ("embed", "inner")),
        "w_x": PSpec((d, di), ("embed", "inner")),
        "w_B": PSpec((d, n), ("embed", "state")),
        "w_C": PSpec((d, n), ("embed", "state")),
        "w_dt": PSpec((d, h), ("embed", "ssm_heads")),
        "conv_x": PSpec((w, di), ("conv", "inner"), init="normal"),
        "conv_B": PSpec((w, n), ("conv", "state"), init="normal"),
        "conv_C": PSpec((w, n), ("conv", "state"), init="normal"),
        "dt_bias": PSpec((h,), ("ssm_heads",), init="zeros", dtype="float32"),
        "A_log": PSpec((h,), ("ssm_heads",), init="zeros", dtype="float32"),
        "D": PSpec((h,), ("ssm_heads",), init="ones", dtype="float32"),
        "norm": PSpec((di,), ("inner",), init="ones", dtype="float32"),
        "w_out": PSpec((di, d), ("inner", "embed")),
    }


def _causal_conv(x: Array, kernel: Array) -> Array:
    """Depthwise causal conv. x: (B,S,C); kernel: (W,C)."""
    w, s = kernel.shape[0], x.shape[1]
    kernel = use_weight(kernel, x.dtype)
    # the w - 1 leading zeros by cat, not F.pad: torch 2.11's DTensor
    # cannot plan pad's redistribution on the production layout
    zeros = torch.zeros_like(x[:, :1]).expand(-1, w - 1, -1)
    pad = torch.cat([zeros, x], dim=1)
    acc = torch.zeros_like(x)
    for i in range(w):
        acc = acc + pad[:, i:i + s] * kernel[i]
    return acc


_PROJ_IN = (("w_z", "inner"), ("w_x", "inner"), ("w_B", "state"),
            ("w_C", "state"), ("w_dt", "ssm_heads"))


def _proj_in(cfg: ModelConfig, p: Dict, x: Array):
    """z, x, B, C, dt of x (B,S,D): each weight placed for its product
    (``use_weight``), the Partial sums of the ones whole over "model"
    (state, and heads that do not divide) reduced."""
    return tuple(_product(x, p[n], "batch", "seq", axis)
                 for n, axis in _PROJ_IN)


def _product(x: Array, w: Array, *out) -> Array:
    """x @ w, both placed for it (``product_operands``), the result
    constrained to ``out``."""
    x, w = product_operands(x, w, x.dtype, ((0, -1),))
    return constrain(matmul_rows(x, w), *out)


def _proj_out(p: Dict, y: Array) -> Array:
    """The output projection of (B, S, d_inner) rows, its Partial sum
    over the inner dimension reduced."""
    return _product(y, p["w_out"], "batch", "seq", None)


class _CumSum(torch.autograd.Function):
    """``torch.cumsum`` along ``dim`` with torch's own backward (the
    reversed cumulative sum, ``flip``, ``cumsum``, ``flip``) run on each
    shard of a DTensor gradient (``on_local_shards``): torch 2.11's
    DTensor has no strategy for ``flip``, and the dimension summed (a
    chunk's positions) is never sharded.  Bit-equal to torch.cumsum's
    autograd on plain tensors."""

    @staticmethod
    def forward(ctx, x: Array, dim: int) -> Array:
        ctx.dim = dim
        return torch.cumsum(x, dim)

    @staticmethod
    def backward(ctx, g: Array):
        d = ctx.dim
        return on_local_shards(lambda t: t.flip(d).cumsum(d).flip(d), g,
                               d), None


def _decay(diff: Array, tri: Array) -> Array:
    """exp(diff) where ``tri``, else 0.  The mask goes in before the exp
    (``repro`` masks after it): above the diagonal ``diff`` overflows exp
    to inf at long chunks, and the backward of a mask after it gives
    0 * inf = NaN.  exp(-inf) = 0, so the values are ``repro``'s form's
    bit for bit."""
    return torch.exp(torch.where(tri, diff, float("-inf")))


def ssd_chunked(cfg: ModelConfig, xh: Array, dt: Array, b: Array, c: Array,
                a_log: Array, init_state: Array = None
                ) -> Tuple[Array, Array]:
    """Chunked SSD scan.
    xh: (B,S,H,P); dt: (B,S,H) fp32; b,c: (B,S,N); a_log: (H,) fp32 (=A<0).
    Returns (y (B,S,H,P), final_state (B,H,P,N)).

    On DTensors it runs on each rank's own rows and heads
    (``on_own_rows``): rows, heads and chunks are independent but for
    the heads' shared C·B products."""
    if init_state is None:
        own = on_own_rows(
            lambda *a: ssd_chunked(cfg, *a), (xh, dt, b, c, a_log),
            ((0, 2), (0, 2), (0, None), (0, None), (None, 0)),
            ((0, 2), (0, 1)))
        if own is not None:
            return own
    bsz, s, h, pdim = xh.shape
    n = b.shape[-1]
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q

    xdt = xh.float() * dt[..., None]                     # (B,S,H,P)
    a = dt * a_log                                       # (B,S,H)  <= 0
    cum = _CumSum.apply(a.reshape(bsz, nc, q, h), 2)     # (B,NC,Q,H)
    xdt_c = xdt.reshape(bsz, nc, q, h, pdim)
    b_c = b.reshape(bsz, nc, q, n).float()
    c_c = c.reshape(bsz, nc, q, n).float()

    # ---- intra-chunk (attention-like dual form) ----
    # L[i,j] = exp(cum_i - cum_j) for i >= j else 0
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,NC,Q,Q,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    l_mat = _decay(diff, tri[None, None, :, :, None])
    g_mat = torch.einsum("bcqn,bckn->bcqk", c_c, b_c)     # (B,NC,Q,Q)
    m_mat = g_mat[..., None] * l_mat                      # (B,NC,Q,Q,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m_mat, xdt_c)

    # ---- chunk states ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,NC,Q,H) <= 1
    # two operands, the decay taken into x first: the order in which
    # opt_einsum contracts the three-operand "bckn,bckh,bckhp->bchpn"
    # (bit-equal to it), and one DTensor runs on the production layout's
    # shards, where the three-operand form stops at a local `view`
    xd = xdt_c * decay_to_end[..., None]                  # (B,NC,Q,H,P)
    s_chunk = torch.einsum("bckn,bckhp->bchpn", b_c, xd)  # (B,NC,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,NC,H)

    # ---- inter-chunk recurrence ----
    state = init_state
    if state is None:
        state = torch.zeros((bsz, h, pdim, n), dtype=torch.float32,
                            device=xh.device)
    states_in = []
    for i in range(nc):
        states_in.append(state)
        state = chunk_decay[:, i, :, None, None] * state + s_chunk[:, i]
    states_in = torch.stack(states_in, dim=1)             # (B,NC,H,P,N)

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp",
                           c_c, torch.exp(cum), states_in)
    y = (y_intra + y_inter).reshape(bsz, s, h, pdim)
    return y.to(xh.dtype), state


def ssm_block(cfg: ModelConfig, p: Dict, x: Array,
              return_cache: bool = False):
    """Full Mamba2 mixer over a sequence. x: (B,S,D).
    With ``return_cache`` also returns the O(1) decode cache (conv tails +
    final SSD state) so prefill can hand off to the recurrent decode step."""
    bsz, s, _ = x.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_headdim
    w = cfg.ssm_conv
    z, xin_r, b_r, c_r, dt = _proj_in(cfg, p, x)
    xin = F.silu(_causal_conv(xin_r, p["conv_x"]))
    b = F.silu(_causal_conv(b_r, p["conv_B"]))
    c = F.silu(_causal_conv(c_r, p["conv_C"]))
    xin = shard(xin, "batch", "seq", "inner")
    dt = F.softplus(dt.float() + p["dt_bias"])
    a_log = -torch.exp(p["A_log"])
    xh = xin.reshape(bsz, s, h, pdim)
    y, final_state = ssd_chunked(cfg, xh, dt, b, c, a_log)
    y = y + xh.float().to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, cfg.d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = _proj_out(p, y)
    if not return_cache:
        return out
    cache = {"conv_x": xin_r[:, s - (w - 1):],
             "conv_B": b_r[:, s - (w - 1):],
             "conv_C": c_r[:, s - (w - 1):],
             "state": final_state}
    return out, cache


# ---------------------------------------------------------------------------
# decode (O(1) state)
# ---------------------------------------------------------------------------

def ssm_cache_specs(cfg: ModelConfig, batch: int, dtype: torch.dtype
                    ) -> Tuple[Dict, Dict]:
    """(TensorSpecs, logical axes) of one layer's decode cache."""
    di, n = cfg.d_inner, cfg.ssm_state
    w = cfg.ssm_conv
    shapes = {
        "conv_x": TensorSpec((batch, w - 1, di), dtype),
        "conv_B": TensorSpec((batch, w - 1, n), dtype),
        "conv_C": TensorSpec((batch, w - 1, n), dtype),
        "state": TensorSpec((batch, cfg.ssm_heads, cfg.ssm_headdim, n),
                            torch.float32),
    }
    axes = {
        "conv_x": ("batch", None, "inner"),
        "conv_B": ("batch", None, "state"),
        "conv_C": ("batch", None, "state"),
        "state": ("batch", "ssm_heads", None, None),
    }
    return shapes, axes


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> Dict:
    shapes, _ = ssm_cache_specs(cfg, batch, dtype)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in shapes.items()}


def _conv_step(buf: Array, new: Array, kernel: Array) -> Tuple[Array, Array]:
    """buf: (B,W-1,C) previous raw inputs; new: (B,C). Returns (y, buf').
    The W taps are summed in float32 and rounded once (``repro``'s
    contraction over W)."""
    win = torch.cat([buf, new[:, None]], dim=1)           # (B,W,C)
    y = (win.float() * use_weight(kernel, win.dtype).float()).sum(dim=1)
    return y.to(win.dtype), win[:, 1:]


def ssm_decode_step(cfg: ModelConfig, p: Dict, x: Array, cache: Dict
                    ) -> Tuple[Array, Dict]:
    """One-token recurrent step. x: (B,1,D). Returns (out (B,1,D), cache')."""
    bsz = x.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_headdim
    z, xin_r, b_r, c_r, dt = (v[:, 0] for v in _proj_in(cfg, p, x))

    xin, conv_x = _conv_step(cache["conv_x"], xin_r, p["conv_x"])
    b, conv_b = _conv_step(cache["conv_B"], b_r, p["conv_B"])
    c, conv_c = _conv_step(cache["conv_C"], c_r, p["conv_C"])
    xin, b, c = F.silu(xin), F.silu(b), F.silu(c)

    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,H)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))                # (B,H)

    # the heads stay flattened with their channels, (B, H*P): the inner
    # dimension's "model" shard carries through y, where a (B, H, P) view
    # of it would be gathered (H does not divide); the values are the
    # (B, H, P) form's, bit for bit
    def per_channel(v: Array) -> Array:        # (..., H) -> (..., H*P)
        return v[..., None].expand(*v.shape, pdim).reshape(
            *v.shape[:-1], h * pdim)

    # the update runs where the state lies (each rank's rows, its heads
    # whole where they do not divide), so the state leaves on the cache's
    # placements: the small per-row inputs move to it, and the product
    # with C takes the state's slice on x's inner shard
    prev = cache["state"]
    xf = xin.float()                                              # (B,H*P)
    xh = placed_as(xf, prev, 2)
    xdt = xh * per_channel(placed_as(dt, prev, 2))
    state = prev.reshape(bsz, h * pdim, -1) * \
        per_channel(placed_as(decay, prev, 2))[..., None] + \
        xdt[..., None] * placed_as(b.float(), prev, 1)[:, None]
    y = torch.einsum("bjn,bn->bj", placed_as(state, xf, 2),
                     placed_as(c.float(), xf, 1))
    y = y + xf * per_channel(p["D"])
    y = y.to(x.dtype)
    state = state.reshape(prev.shape)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = _proj_out(p, y[:, None])
    cache = {"conv_x": conv_x, "conv_B": conv_b, "conv_C": conv_c,
             "state": state}
    return out, cache
