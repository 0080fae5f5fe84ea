"""Mixture-of-Experts FFN with sort-based routing.  Mirrors
``repro.models.moe``.

Routing is a sort: the (token, choice) pairs are sorted by expert so each
expert's tokens are contiguous, bucketed into a dense (E, C, D) capacity
buffer, run through batched matmuls and combined back per token.  Pairs
beyond an expert's capacity are dropped (Switch/GShard semantics).

Two layouts, chosen by token count as in ``repro``: one global group when
B·S <= 4096 (decode, short prefill), else every sequence row routes on
its own with capacity ``_capacity(cfg, S)``.  The two drop different
pairs.  Padding tokens route and take capacity like any other token.

What decides parity, and how the port keeps it on the card:
  * the experts are chosen by a stable descending sort, so ties go to the
    lower expert as in ``jax.lax.top_k`` (``torch.topk`` fixes no tie
    order on CUDA);
  * the pairs are grouped by a stable sort, so within an expert they keep
    token order, and that order decides which overflow (the default sort
    is not stable on CUDA);
  * each token's kept outputs are summed in ascending expert order in the
    activation dtype, rounding after each add: the order of ``repro``'s
    scatter-add, whose updates run in sorted order.  The port does not
    use ``index_add_``, which adds in no fixed order on the card.

On the trainer's production layout the same code runs on DTensors: the
experts sharded over "model", the rows over the batch axes.  Every index
op is one DTensor can place on torch 2.11 and 2.13: a sort, a gather, an
integer scatter-add or a running sum (``searchsorted`` has no strategy
on either, ``cummax`` none on 2.11).  Per-row routing stays on
the rows' ranks; global routing gathers every token first, as
``repro``'s one sort does.  The expert buffer is sharded over
"experts" before the products, so a rank multiplies only its own
experts, and the expert weights are gathered over "data" for them
(``product_operands``): the buffer keeps its rows (where they do not
divide over "data", the weights keep their shard there and the
contraction is split instead).  Explicit expert parallelism (``cfg.moe_ep``) is
``moe_ep.moe_ffn_ep``, which falls back to ``moe_ffn`` without a mesh.

``moe_ffn`` records the program spans (``core/obs/trace.py``)
``moe.route`` (router product, top-k sort, balance loss),
``moe.dispatch`` (``expert_slots`` and the buffer's gather),
``moe.experts`` (the three products) and ``moe.combine``, and counts the
routed (token, expert) pairs and those kept within capacity
(``moe.pairs_routed``, ``moe.pairs_kept``; on a mesh, each rank's own),
tallied on the device.  Padding tokens count like any other.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.obs.trace import count, span
from repro_torch.models.params import PSpec
from repro_torch.models.sharding import (constrain, matmul_rows,
                                         product_operands, shard)

Array = torch.Tensor

_GLOBAL_ROUTE_MAX_TOKENS = 4096  # decode-sized workloads use the global sort


def moe_specs(cfg: ModelConfig) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": PSpec((d, e), ("embed", "experts"), dtype="float32"),
        "w_gate": PSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_up": PSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_down": PSpec((e, f, d), ("experts", "ffn", "embed")),
    }


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(cfg.capacity_factor * tokens_per_group *
            cfg.experts_per_token / cfg.num_experts)
    return max(8, _round_up(c, 8))


def _route(logits: Array, k: int) -> Tuple[Array, Array]:
    """Top-k routing probabilities. logits: (..., E) fp32.
    Returns (weights (...,k), indices (...,k) int64); equal logits go to
    the lower expert."""
    gate, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(gate[..., :k], dim=-1), idx[..., :k]


def _expert_starts(flat_e: Array, num_experts: int) -> Tuple[Array, Array]:
    """(count, first sorted index) of each expert's pairs, (G, E) each:
    the counts from an integer scatter-add (exact in any order), the
    starts their exclusive running sum (``repro``'s ``searchsorted`` of
    the sorted experts), in O(T·K) memory."""
    counts = flat_e.new_zeros((flat_e.shape[0], num_experts)).scatter_add(
        1, flat_e, torch.ones_like(flat_e))
    return counts, torch.cumsum(counts, dim=1) - counts


def expert_slots(idx: Array, num_experts: int, capacity: int
                 ) -> Tuple[Array, Array, Array]:
    """Where each routed pair of each group goes.  idx: (G, T, K) experts.
    Returns, over the G groups' T·K pairs in token-major order: the
    stable sort by expert ``order`` (G, TK), and in that sorted order
    ``keep`` (the pair is within its expert's ``capacity``) and ``slot``
    (its row of the (E·C + 1)-row buffer; dropped pairs go to the last)."""
    g, t, k = idx.shape
    flat_e = idx.reshape(g, t * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    _, starts = _expert_starts(flat_e, num_experts)
    pos = torch.arange(t * k, device=idx.device) - torch.gather(starts, 1,
                                                                se)
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, num_experts * capacity)
    return order, keep, slot


def _buffer_pairs(idx: Array, order: Array, num_experts: int,
                  capacity: int) -> Array:
    """(G, E·C): the token-major pair that fills each row of the expert
    buffer, T·K where none does.  Row (e, c) takes the sorted pair
    ``start[e] + c`` while c is below e's count."""
    g, t, k = idx.shape
    counts, starts = _expert_starts(idx.reshape(g, t * k), num_experts)
    c = torch.arange(capacity, device=idx.device)
    filled = c < counts[..., None]                        # (G, E, C)
    j = torch.where(filled, starts[..., None] + c, 0).reshape(g, -1)
    return torch.where(filled.reshape(g, -1), torch.gather(order, 1, j),
                       t * k)


def _dispatch_combine(cfg: ModelConfig, p: Dict, x: Array, weights: Array,
                      idx: Array, capacity: int) -> Array:
    """Sort-based dispatch for G token groups routed independently.
    x: (G, T, D); weights/idx: (G, T, K).  Returns (G, T, D).

    Every index op is a gather, so DTensor can place each one (the
    trainer's production layout) and the backward adds each gradient
    once: the buffer gathers its rows from the token-major pairs (each
    token's row repeated K times, whose gradients a sum over K adds in
    a fixed order) with a zero row for the empty ones, and the combine
    gathers each pair's row of the expert outputs, whose zero row takes
    the dropped pairs."""
    g, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tk = t * k
    with span("moe.dispatch"):
        order, keep, slot = expert_slots(idx, e, capacity)
        mine = keep.to_local() if hasattr(keep, "to_local") else keep
        count("moe.pairs_routed", mine.numel())
        count("moe.pairs_kept", mine)

        pairs = x[:, :, None, :].expand(g, t, k, d).reshape(g, tk, d)
        pairs = torch.cat([pairs, pairs.new_zeros((g, 1, d))], dim=1)
        rows = _buffer_pairs(idx, order, e, capacity)
        buf = torch.gather(pairs, 1,
                           rows[..., None].expand(g, e * capacity, d))
        # (G, E, C, D) -> (E, G·C, D): one batched matmul per weight, on
        # this rank's experts
        xe = buf.reshape(g, e, capacity, d).transpose(0, 1).reshape(
            e, g * capacity, d)
        xe = shard(xe, "experts", "batch", None)

    def product(a, name, *out):
        a, w = product_operands(a, p[name], x.dtype, ((1, -1),), rows=1)
        return constrain(torch.bmm(a, w), "experts", "batch", *out)

    with span("moe.experts"):
        h = F.silu(product(xe, "w_gate", "ffn")) * product(xe, "w_up",
                                                           "ffn")
        out = product(h, "w_down", None)
    with span("moe.combine"):
        out = out.reshape(e, g, capacity, d).transpose(0, 1).reshape(
            g, e * capacity, d)
        out = torch.cat([out, out.new_zeros((g, 1, d))], dim=1)

        # back to token-major pairs, each token's in ascending expert
        # order (repro's scatter-add order; a token's k experts are
        # distinct); the inverse of the permutation ``order`` is its
        # argsort
        inv = torch.argsort(order, dim=-1, stable=True)
        by_e = torch.argsort(idx, dim=-1, stable=True)
        slot_t, keep_t = (torch.gather(torch.gather(a, 1, inv).reshape(
            g, t, k), 2, by_e) for a in (slot, keep))
        coef = (torch.gather(weights, 2, by_e) * keep_t).to(out.dtype)
        gathered = torch.gather(
            out, 1, slot_t.reshape(g, tk, 1).expand(g, tk, d)).reshape(
                g, t, k, d) * coef[..., None]
        y = torch.zeros_like(gathered[:, :, 0])
        for j in range(k):
            y = y + gathered[:, :, j]
    return y


def moe_ffn(cfg: ModelConfig, p: Dict, x: Array) -> Tuple[Array, Array]:
    """x: (B, S, D) -> (out (B,S,D), aux_loss scalar)."""
    b, s, d = x.shape
    with span("moe.route"):
        xf, router = product_operands(x.float(), p["router"],
                                      torch.float32, ((0, -1),))
        logits = constrain(matmul_rows(xf, router), "batch", "seq",
                           "experts")
        weights, idx = _route(logits, cfg.experts_per_token)

        # load-balancing auxiliary loss (Switch-style), in float32; the
        # one-hot by comparison (F.one_hot checks its input's range on
        # the host)
        probs = torch.softmax(logits, dim=-1)                   # (B,S,E)
        experts = torch.arange(cfg.num_experts, device=x.device)
        frac_tokens = torch.mean((idx[..., :1] == experts).float(),
                                 dim=(0, 1))
        frac_probs = torch.mean(probs, dim=(0, 1))
        aux = cfg.num_experts * torch.sum(frac_tokens * frac_probs)

    if b * s <= _GLOBAL_ROUTE_MAX_TOKENS:
        cap = _capacity(cfg, b * s)
        y = _dispatch_combine(cfg, p, x.reshape(1, b * s, d),
                              weights.reshape(1, b * s, -1),
                              idx.reshape(1, b * s, -1), cap)
        return y.reshape(b, s, d), aux

    # per-row routing: every sequence row is its own group
    y = _dispatch_combine(cfg, p, x, weights, idx, _capacity(cfg, s))
    y = shard(y, "batch", "seq", None)
    return y, aux
