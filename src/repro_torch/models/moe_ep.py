"""Explicit expert-parallel MoE FFN over a device mesh, a port of
``repro.models.moe_ep`` on ``torch.distributed``.

``repro`` runs this body under ``shard_map``; here every rank of the
mesh runs it on its own rows, and the tokens travel between the ranks of
the "model" axis by two ``all_to_all``s:

  per rank:  t local tokens, k experts each
    1. route, then sort the (token, choice) pairs by the shard owning
       their expert (E/M experts per shard) into an (M, cap, D) buffer
    2. all_to_all the buffer (and each pair's local expert id): every
       shard receives the pairs routed to its experts
    3. a local sort by expert into an (E/M, cap_e, D) buffer, batched
       expert GEMMs
    4. all_to_all the outputs back into the slots they were sent from,
       and combine them with the router weights

The hops are ``torch.distributed._functional_collectives``'
``all_to_all_single_autograd`` (its backward sends the cotangents back
the same way), so the experts train and the dry run's op counter sees
and prices them.  The numerics are ``repro``'s EP body's, not
``moe.moe_ffn``'s: the router product takes the router in the activation
dtype with float32 accumulation; the capacities are per hop
(``cap_send``, then ``cap_e`` with 1.25 over-provision when a shard
holds more than one expert); the balance loss is each rank's estimate
averaged over the model axis; a token's outputs are summed in its
routing order.  Every sort is stable, as ``jnp.argsort``.

Without an active mesh, without ``axis`` on it, or when the experts do
not divide over it, this is ``moe.moe_ffn`` (``repro``'s fallback).

On the production layout's DTensors the body runs on local shards with
``repro``'s ``shard_map`` in_specs (``_on_shards``): x's rows split over
the batch axes, the router whole, the experts split along E over
"model" (their FSDP shard over "data" gathered).  Plain tensors under a
mesh are taken as the body's own arguments: this rank's rows, the whole
router and this rank's E/M experts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as M
from repro_torch.models.sharding import (current_mesh, live_placements,
                                         mesh_shape, placements, spec_for)

Array = torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _sort_bucket(values: Array, keys: Array, num_buckets: int,
                 capacity: int, fill_value=0) -> Tuple[Array, Array]:
    """Stable-sort the rows of ``values`` by ``keys`` and place them in a
    dense (num_buckets, capacity) layout; keys >= num_buckets and rows
    past a bucket's capacity are dropped.  Returns (the bucketed values,
    the slot each input row landed in, -1 where dropped)."""
    n = values.shape[0]
    order = torch.argsort(keys, stable=True)
    skey = keys[order]
    start = torch.searchsorted(
        skey, torch.arange(num_buckets, device=keys.device))
    pos = (torch.arange(n, device=keys.device)
           - start[skey.clamp(max=num_buckets - 1)])
    keep = (pos < capacity) & (skey < num_buckets)
    slot = torch.where(keep, skey * capacity + pos, num_buckets * capacity)
    buf = torch.full((num_buckets * capacity + 1,) + values.shape[1:],
                     fill_value, dtype=values.dtype, device=values.device)
    buf = buf.index_put((slot,), values[order])        # sorted order
    # the slot of each ORIGINAL row (the sort inverted)
    inv_slot = torch.full((n,), -1, dtype=torch.int64, device=keys.device)
    inv_slot[order] = torch.where(keep, slot, -1)
    return (buf[:-1].reshape((num_buckets, capacity) + values.shape[1:]),
            inv_slot)


def _hop(x: Array, group) -> Array:
    """Block i of ``x`` (dim 0, split evenly) to rank i of ``group``;
    differentiable."""
    from torch.distributed import _functional_collectives as fc
    return fc.all_to_all_single_autograd(x.contiguous(), None, None, group)


class _ModelMean(torch.autograd.Function):
    """``jax.lax.pmean`` over ``group``: the mean of every rank's value,
    whose transpose is the same mean of the cotangents."""

    @staticmethod
    def forward(ctx, x, group, n):
        from torch.distributed import _functional_collectives as fc
        ctx.group, ctx.n = group, n
        return fc.wait_tensor(fc.all_reduce(x, "sum", group)) / n

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as fc
        return (fc.wait_tensor(fc.all_reduce(g.contiguous(), "sum",
                                             ctx.group)) / ctx.n,
                None, None)


class _GradScale(torch.autograd.Function):
    """The identity, its gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def moe_ffn_ep(cfg: ModelConfig, p: Dict, x: Array,
               axis: str = "model") -> Tuple[Array, Array]:
    """Drop-in for ``moe.moe_ffn`` when a mesh with ``axis`` is active.
    On DTensors (the production layout): x (B, S, D) and the leaves of
    ``p`` as the trainer holds them -> (out on x's placements, aux).  On
    plain tensors: this rank's (B_l, S, D) rows and E/M experts ->
    (out (B_l, S, D), aux scalar)."""
    mesh = current_mesh()
    sizes = mesh_shape(mesh) if mesh is not None else {}
    if axis not in sizes or cfg.num_experts % sizes[axis] != 0:
        return M.moe_ffn(cfg, p, x)
    if hasattr(x, "placements"):
        return _on_shards(cfg, mesh, axis, p, x)
    m_sz = sizes[axis]
    w = [p[n].to(x.dtype) for n in ("w_gate", "w_up", "w_down")]
    if w[0].shape[0] != cfg.num_experts // m_sz:
        raise ValueError(f"{w[0].shape[0]} experts on a rank of {m_sz} "
                         f"over {axis!r}: pass the rank's "
                         f"{cfg.num_experts // m_sz} of {cfg.num_experts}")
    return _ep_body(cfg, mesh.get_group(axis), m_sz, x, p["router"], *w)


def _on_shards(cfg: ModelConfig, mesh, axis: str, p: Dict, x: Array
               ) -> Tuple[Array, Array]:
    """The body on the local shards of the production layout's DTensors,
    as ``repro``'s ``shard_map`` places its operands: x's rows split over
    the batch axes (the rules' "batch"), replicated elsewhere; the router
    whole; the experts, cast first, split along E over ``axis`` and
    gathered elsewhere.  Every rank of an ``axis`` group holds the same
    rows and routes them alike, so x's and the router's gradients are
    each rank's own over ``axis``, and ``Partial`` over the batch axes
    (each data rank saw its own rows); an expert receives each pair once
    from every rank of the group, so its gradient is scaled by 1/M, and
    is ``Partial`` over the batch axes.  y leaves on x's placements, aux
    as the mean of the data ranks' estimates (a ``Partial`` sum of each
    over their count)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    j = mesh.mesh_dim_names.index(axis)
    m_sz = mesh.size(j)
    rows = live_placements(placements(spec_for(
        x.shape, ("batch",), record=False), mesh), mesh)
    split = [k for k, q in enumerate(rows) if q.is_shard()]
    n_split = 1
    for k in split:
        n_split *= mesh.size(k)
    summed = tuple(Partial() if k in split else Replicate()
                   for k in range(mesh.ndim))
    whole = (Replicate(),) * mesh.ndim

    def local(t: Array, pl, grad_pl) -> Array:
        if tuple(t.placements) != tuple(pl):
            t = t.redistribute(mesh, pl)
        return t.to_local(grad_placements=grad_pl)

    xl = local(x, rows, rows)
    router = local(p["router"], whole, summed)
    experts = tuple(Shard(0) if k == j else Replicate()
                    for k in range(mesh.ndim))
    expert_grads = tuple(Shard(0) if k == j else q
                         for k, q in enumerate(summed))
    w = [local(p[n].to(x.dtype), experts, expert_grads)
         for n in ("w_gate", "w_up", "w_down")]
    if m_sz > 1:
        w = [_GradScale.apply(t, 1.0 / m_sz) for t in w]
    y, aux = _ep_body(cfg, mesh.get_group(axis), m_sz, xl, router, *w)
    y = DTensor.from_local(y, mesh, rows, run_check=False, shape=x.shape,
                           stride=x.stride())
    if tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(mesh, x.placements)
    aux = DTensor.from_local(aux / n_split if n_split > 1 else aux, mesh,
                             summed, run_check=False, shape=aux.shape,
                             stride=aux.stride())
    return y, aux


def _ep_body(cfg: ModelConfig, group, m_sz: int, x: Array, router: Array,
             wg: Array, wu: Array, wd: Array) -> Tuple[Array, Array]:
    """One rank's body.  x: (B_l, S, D) local tokens; wg/wu/wd: its
    (E_l, D, F) / (E_l, F, D) experts."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    e_l = e // m_sz
    t = b * s
    xf = x.reshape(t, d)
    dev = x.device

    # the router in the activation dtype, float32 accumulation: products
    # of two activation-dtype values are exact in float32
    logits = torch.matmul(xf.float(), router.to(xf.dtype).float())
    weights, idx = M._route(logits, k)                 # (t, k)

    # load-balance aux: this rank's estimate, averaged over the axis
    probs = torch.softmax(logits, dim=-1)
    experts = torch.arange(e, device=dev)
    frac_tokens = torch.mean((idx[:, :1] == experts).float(), dim=0)
    aux = e * torch.sum(frac_tokens * torch.mean(probs, dim=0))
    if m_sz > 1:
        aux = _ModelMean.apply(aux, group, m_sz)

    # ---- hop 1: pairs -> the shard owning their expert (features and
    # local expert ids bucketed alike, so the slots line up) ----
    tk = t * k
    flat_e = idx.reshape(tk)                           # global expert id
    dst = flat_e // e_l                                # owning shard
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_w = weights.reshape(tk)

    cap_send = _round_up(max(int(cfg.capacity_factor * tk / m_sz), 8), 8)
    send_x, sent_slot = _sort_bucket(xf[flat_t], dst, m_sz, cap_send)
    send_e, _ = _sort_bucket(flat_e % e_l, dst, m_sz, cap_send,
                             fill_value=-1)
    rx = _hop(send_x, group).reshape(m_sz * cap_send, d)
    rexp = _hop(send_e, group).reshape(m_sz * cap_send)   # -1 = padding

    # ---- local expert GEMMs (bucketed per local expert); a shard of one
    # expert needs no second over-provision: every received row fits ----
    over = 1.25 if e_l > 1 else 1.0
    cap_e = _round_up(max(int(m_sz * cap_send / e_l * over), 8), 8)
    buf, rslot = _sort_bucket(rx, torch.where(rexp >= 0, rexp, e_l), e_l,
                              cap_e)
    buf = buf.to(wg.dtype)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out = torch.bmm(h, wd)                             # (E_l, cap_e, D)

    # un-bucket into the received order, send back into the SAME slots
    out_flat = torch.cat([out.reshape(e_l * cap_e, d),
                          out.new_zeros((1, d))])
    back = out_flat[torch.where(rslot >= 0, rslot, e_l * cap_e)]
    ret = _hop(back.reshape(m_sz, cap_send, d), group)
    ret_flat = torch.cat([ret.reshape(m_sz * cap_send, d),
                          ret.new_zeros((1, d))])

    # ---- combine: each (token, choice)'s output by its sent slot, summed
    # per token in routing order
    contrib = ret_flat[torch.where(sent_slot >= 0, sent_slot,
                                   m_sz * cap_send)]
    coef = torch.where(sent_slot >= 0, flat_w, 0.0).to(contrib.dtype)
    contrib = (contrib * coef[:, None]).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=contrib.dtype, device=dev)
    for j in range(k):
        y = y + contrib[:, j]
    return y.reshape(b, s, d).to(x.dtype), aux
