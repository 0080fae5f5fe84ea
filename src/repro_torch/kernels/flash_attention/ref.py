"""Plain PyTorch version of flash attention: exact softmax GQA attention
with float32 scores (a copy of repro's kernels/flash_attention/ref.py)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, Kv, D); H = Kv * G.  Returns (B,S,H,D).
    Scores are float32 products of the exact inputs (bf16 widens exactly);
    the probabilities are rounded to v's dtype before the float32 P . V,
    as repro's einsum does."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) * (d ** -0.5)
    if causal:
        mask = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out.reshape(b, s, h, d)
