"""The plain reference of the benchmark's language models, in PyTorch
alone: no kernel, no cache, no batching, nothing of the program.

A decoder-only transformer as the configuration file states it: RMSNorm,
rotate-half RoPE, grouped-query causal attention (within a packed row,
each document attends to itself alone), SwiGLU feed-forward or a
top-k mixture of experts, an untied output head.  The mixture follows
the port's published-model departures that the configuration file lists:
the top-k weights renormalised by a softmax over the k chosen logits,
ties to the lower expert, and capacity ``capacity_factor * tokens * k /
experts`` (rounded up to 8, at least 8) per group, a group being the
whole batch up to 4,096 tokens and each row beyond, the pairs taken in
token order; the Switch balance loss on the first choice, weighted 0.01.

``precision`` is "float32" (TF32 off; the caller sets the matmul
precision) or "fp8": every product's operands rounded to float8 e4m3 with
one scale a tensor, the step below the bfloat16 the configurations
compute in (the control that a sound comparison has to fail); in
training the control also holds each parameter one step below its
configured dtype (``stored``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
E4M3_MAX = 448.0
GLOBAL_GROUP_TOKENS = 4096
AUX_WEIGHT = 0.01
# routed (token, expert) pairs within capacity and in all, over every
# mixture forward since the last reset: the share that the operation
# counts (which take all k pairs of a token) overstate
ROUTED = {"kept": 0, "all": 0}
NEG = -1e30


class Dims:
    """The sizes of a configuration file."""

    def __init__(self, cf: Dict):
        self.d = int(cf["hidden_size"])
        self.heads = int(cf["num_attention_heads"])
        self.kv = int(cf["num_key_value_heads"])
        self.hd = int(cf.get("head_dim") or self.d // self.heads)
        self.ff = int(cf["intermediate_size"])
        self.vocab = int(cf["vocab_size"])
        self.layers = int(cf["num_hidden_layers"])
        self.eps = float(cf["rms_norm_eps"])
        self.theta = float(cf["rope_theta"])
        self.experts = int(cf.get("num_experts", 0))
        self.k = int(cf.get("num_experts_per_tok", 0))
        self.capacity_factor = float(cf.get("capacity_factor", 1.25))


def _q8(x: Tensor) -> Tensor:
    """x rounded to e4m3 under one scale, gradients passed straight."""
    s = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def stored(x: Tensor, dtype: str) -> Tensor:
    """``x`` as a parameter held one step below ``dtype`` would hold it:
    float32 in bfloat16, bfloat16 in float8 e4m3 under one scale."""
    if dtype == "float32":
        return x.to(torch.bfloat16).to(x.dtype)
    if dtype == "bfloat16":
        return _q8(x)
    raise ValueError(f"no step below {dtype!r}")


def mm(a: Tensor, b: Tensor, precision: str) -> Tensor:
    if precision == "fp8":
        a, b = _q8(a), _q8(b)
    return a @ b


def rmsnorm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """x (B, S, H, D), pos (B, S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[..., None] * freq
    sin, cos = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(dm: Dims, p: Dict, h: Tensor, pos: Tensor,
              seg: Optional[Tensor], precision: str,
              q_block: int = 1024) -> Tensor:
    """Causal in positions, and within a segment where ``seg`` is given.
    Queries in blocks of ``q_block`` to bound the score tensor."""
    b, s, d = h.shape
    g = dm.heads // dm.kv
    q = mm(h, p["wq"].reshape(d, -1), precision).view(b, s, dm.heads, dm.hd)
    k = mm(h, p["wk"].reshape(d, -1), precision).view(b, s, dm.kv, dm.hd)
    v = mm(h, p["wv"].reshape(d, -1), precision).view(b, s, dm.kv, dm.hd)
    q, k = rope(q, pos, dm.theta), rope(k, pos, dm.theta)
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)      # (B, H, S, D)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for a in range(0, s, q_block):
        qs = q[:, :, a:a + q_block]
        sc = mm(qs, k.transpose(-1, -2), precision) / math.sqrt(dm.hd)
        m = pos[:, a:a + q_block, None] >= pos[:, None, :]
        if seg is not None:
            m = m & (seg[:, a:a + q_block, None] == seg[:, None, :])
        sc = torch.where(m[:, None], sc, NEG)
        outs.append(mm(torch.softmax(sc, dim=-1), v, precision))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, -1)
    return mm(o, p["wo"].reshape(-1, d), precision)


def mlp(p: Dict, h: Tensor, precision: str) -> Tensor:
    return mm(F.silu(mm(h, p["w_gate"], precision)) *
              mm(h, p["w_up"], precision), p["w_down"], precision)


def _capacity(dm: Dims, tokens: int) -> int:
    c = int(dm.capacity_factor * tokens * dm.k / dm.experts)
    return max(8, -(-c // 8) * 8)


def moe(dm: Dims, p: Dict, h: Tensor, precision: str
        ) -> Tuple[Tensor, Tensor]:
    b, s, d = h.shape
    logits = mm(h, p["router"], precision)                 # (B, S, E)
    gate, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    w, idx = torch.softmax(gate[..., :dm.k], dim=-1), idx[..., :dm.k]
    probs = torch.softmax(logits, dim=-1)
    first = F.one_hot(idx[..., 0], dm.experts).float()
    aux = dm.experts * torch.sum(first.mean((0, 1)) * probs.mean((0, 1)))
    if b * s <= GLOBAL_GROUP_TOKENS:
        groups, cap = idx.reshape(1, b * s, dm.k), _capacity(dm, b * s)
    else:
        groups, cap = idx, _capacity(dm, s)
    # each pair's place among its expert's pairs, in token order
    onehot = F.one_hot(groups.reshape(groups.shape[0], -1), dm.experts)
    rank = (onehot.cumsum(1) - 1).gather(2, groups.reshape(
        groups.shape[0], -1, 1))[..., 0]
    keep = (rank < cap).reshape(b, s, dm.k)
    ROUTED["kept"] += int(keep.sum())
    ROUTED["all"] += keep.numel()
    hf, wk = h.reshape(b * s, d), (w * keep).reshape(b * s, dm.k)
    ik = idx.reshape(b * s, dm.k)
    y = torch.zeros_like(hf)
    for e in range(dm.experts):
        tok, slot = torch.nonzero(ik == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = hf[tok]
        out = mm(F.silu(mm(x, p["w_gate"][e], precision)) *
                 mm(x, p["w_up"][e], precision), p["w_down"][e], precision)
        y = y.index_add(0, tok, out * wk[tok, slot][:, None])
    return y.reshape(b, s, d), aux


def layer(dm: Dims, p: Dict, x: Tensor, pos: Tensor, seg: Optional[Tensor],
          precision: str) -> Tuple[Tensor, Tensor]:
    x = x + attention(dm, p["attn"], rmsnorm(x, p["ln1"], dm.eps), pos, seg,
                      precision)
    h = rmsnorm(x, p["ln2"], dm.eps)
    if "moe" in p:
        f, aux = moe(dm, p["moe"], h, precision)
    else:
        f, aux = mlp(p["mlp"], h, precision), x.new_zeros(())
    return x + f, aux


def hidden(dm: Dims, w: Dict, tokens: Tensor, pos: Tensor,
           seg: Optional[Tensor], precision: str, remat: bool
           ) -> Tuple[Tensor, Tensor]:
    """Final-norm hidden states and the layers' mean balance loss."""
    x = w["embed"]["tok"][tokens.long()]
    auxs = []
    for i in range(dm.layers):
        p = _layer_params(w["layers"], i)
        if remat:
            x, aux = checkpoint(layer, dm, p, x, pos, seg, precision,
                                use_reentrant=False)
        else:
            x, aux = layer(dm, p, x, pos, seg, precision)
        auxs.append(aux)
    return rmsnorm(x, w["embed"]["norm_f"], dm.eps), torch.stack(auxs).mean()


def _layer_params(tree: Dict, i: int) -> Dict:
    return {k: _layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def logits(dm: Dims, w: Dict, x: Tensor, precision: str) -> Tensor:
    return mm(x, w["embed"]["head"].t(), precision)


def loss(dm: Dims, w: Dict, batch: Dict[str, Tensor], precision: str,
         chunk: int = 1024) -> Tuple[Tensor, Tensor]:
    """(mean masked cross-entropy + 0.01 x balance loss, the
    cross-entropy) of a packed batch; the output head in chunks of
    ``chunk`` positions, each checkpointed."""
    x, aux = hidden(dm, w, batch["tokens"], batch["positions"],
                    batch["segment_ids"], precision, remat=True)
    mask = batch["loss_mask"].float()
    tgt = batch["targets"].long()

    def nll(xc, tc, mc):
        lp = torch.log_softmax(logits(dm, w, xc, precision), dim=-1)
        return -(lp.gather(-1, tc[..., None])[..., 0] * mc).sum()

    tot = x.new_zeros(())
    for a in range(0, x.shape[1], chunk):
        sl = slice(a, a + chunk)
        tot = tot + checkpoint(nll, x[:, sl], tgt[:, sl], mask[:, sl],
                               use_reentrant=False)
    ce = tot / mask.sum().clamp(min=1.0)
    return ce + (AUX_WEIGHT * aux if dm.experts else 0.0), ce


@torch.no_grad()
def sequence_logits(dm: Dims, w: Dict, tokens: List[int], at: List[int],
                    precision: str, device) -> Tensor:
    """Logits (len(at), V) of one sequence at positions ``at``."""
    t = torch.tensor([tokens], dtype=torch.int64, device=device)
    pos = torch.arange(len(tokens), device=device)[None]
    x, _ = hidden(dm, w, t, pos, None, precision, remat=False)
    return logits(dm, w, x[0, at], precision)
