"""Flash attention routed by device: CUDA tensors take the hand kernel,
CPU and meta tensors the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels import note_site, on_cuda
from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, Kv, D), H = Kv * G.  Returns
    (B, S, H, D) in q's dtype; causal is top-left (qpos >= kpos)."""
    note_site("flash_attention")
    if on_cuda(q):
        return kernel.flash_attention(q, k, v, causal)
    return ref.flash_attention(q, k, v, causal)
