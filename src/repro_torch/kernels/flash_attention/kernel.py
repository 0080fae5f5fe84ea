"""ctypes wrapper of the CUDA flash attention (csrc/flash_attention.cu)."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import CudaKernel, check_same_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA-core body keeps a 128-wide row in four threads' registers
MAX_HEAD_DIM = 128
# grid y and z
MAX_GRID_YZ = 65535

KERNEL = CudaKernel(
    "flash_attention",
    Path(__file__).parent / "csrc" / "flash_attention.cu",
    {"flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _I)})


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte boundary (the tiles load 16 bytes a
    thread)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, Kv, D), H = Kv * G, float32 or
    bfloat16, D <= 128.  Returns (B, S, H, D) in q's dtype."""
    dev = check_same_cuda(q, k, v)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (B,S,H,D) and k, v "
                         "(B,T,Kv,D) of one shape")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head_dim")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} kv "
                         "heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim 1.."
                         f"{MAX_HEAD_DIM}, got {d}")
    if b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {h} exceed {MAX_GRID_YZ}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    if b == 0 or s == 0 or h == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention needs at least one key")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    KERNEL.launch("flash_attention", dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, s, t, h, kv, d,
                  int(causal), float(d) ** -0.5, DTYPES[q.dtype])
    return out
