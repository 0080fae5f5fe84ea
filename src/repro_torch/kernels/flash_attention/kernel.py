"""ctypes wrapper of the CUDA flash attention (csrc/flash_attention.cu).

Which of the source's three bodies runs is a pure function of (dtype, D):
``body``.  The wgmma body reads q, k and v through TMA tensor maps whose
geometry (``tma_geometry``) is computed and checked here, so that a test
without a card can hold it; the C side only encodes it."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import CudaKernel, check_same_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA-core body keeps a 128-wide row in four threads' registers
MAX_HEAD_DIM = 128
# grid y and z of the mma_sync and cuda_core bodies
MAX_GRID_YZ = 65535

# the wgmma body: bf16 at these head dims, 128 query rows and 64 keys a
# tile, each row read as 64-element (128-byte, the swizzle's span) boxes
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_Q_ROWS, WGMMA_KV_ROWS = 128, 64
TMA_BOX_W = 64
# cuTensorMapEncodeTiled's limits
TMA_MAX_BOX, TMA_SWIZZLE_BYTES, TMA_STRIDE_ALIGN = 256, 128, 16

KERNEL = CudaKernel(
    "flash_attention",
    Path(__file__).parent / "csrc" / "flash_attention.cu",
    {"flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _I, _P),
     "flash_attention_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P, _P)})


def body(dtype: torch.dtype, d: int) -> str:
    """The body that runs for (dtype, head_dim): "wgmma" (bf16, D in
    WGMMA_HEAD_DIMS), "mma_sync" (bf16, another multiple of 16) or
    "cuda_core" (float32, and bf16 of any other D)."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.bfloat16 and d % 16 == 0:
        return "mma_sync"
    return "cuda_core"


class TensorMapGeometry(NamedTuple):
    """One operand's 4-D TMA tensor map over the JAX layout (B, L, heads,
    D), innermost dimension first."""
    dims: Tuple[int, int, int, int]      # (D, heads, L, B)
    strides: Tuple[int, int, int]        # bytes of dims 1..3
    box: Tuple[int, int, int, int]       # (64, 1, rows per load, 1)

    @property
    def d_boxes(self) -> int:
        """Boxes per row along D (two at D = 128)."""
        return self.dims[0] // self.box[0]

    def problems(self, itemsize: int = 2) -> list:
        """What cuTensorMapEncodeTiled or the kernel would refuse."""
        out = []
        if any(s <= 0 or s % TMA_STRIDE_ALIGN for s in self.strides):
            out.append(f"byte strides {self.strides} not positive multiples "
                       f"of {TMA_STRIDE_ALIGN}")
        if any(not 1 <= b <= TMA_MAX_BOX for b in self.box):
            out.append(f"box {self.box} outside 1..{TMA_MAX_BOX}")
        if self.box[0] * itemsize != TMA_SWIZZLE_BYTES:
            out.append(f"inner box of {self.box[0] * itemsize} bytes, not "
                       f"the {TMA_SWIZZLE_BYTES}-byte swizzle span")
        if self.dims[0] % self.box[0]:
            out.append(f"D = {self.dims[0]} not a multiple of the box")
        if any(x < 1 or x >= 2 ** 32 for x in self.dims):
            out.append(f"dims {self.dims} outside 1..2^32-1")
        return out

    def flat(self) -> Tuple[int, ...]:
        return (*self.dims, *self.strides, *self.box)


def tma_geometry(shape: Tuple[int, ...], strides: Tuple[int, ...],
                 rows: int, itemsize: int = 2) -> TensorMapGeometry:
    """The tensor map of a (B, L, heads, D) operand with these element
    strides (D's must be 1), loading ``rows`` rows of L per box."""
    b, n, h, d = shape
    if strides[3] != 1:
        raise ValueError(f"a tensor map reads D unit-stride, got stride "
                         f"{strides[3]}")
    return TensorMapGeometry(
        (d, h, n, b),
        (strides[2] * itemsize, strides[1] * itemsize, strides[0] * itemsize),
        (TMA_BOX_W, 1, rows, 1))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte boundary (the tiles load 16 bytes a
    thread)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.lru_cache(maxsize=1024)
def _map_values(shape: Tuple[int, ...], strides: Tuple[int, ...],
                rows: int) -> Optional[Tuple[int, ...]]:
    """The 11 values the C side encodes for a bf16 operand of this shape
    and these strides, or None where TMA cannot read it in place (a call
    repeats the same few shapes, so each is worked out once)."""
    if strides[3] != 1:
        return None
    g = tma_geometry(shape, strides, rows)
    return None if g.problems() else g.flat()


@functools.lru_cache(maxsize=1024)
def _geometry_array(q: Tuple[int, ...], k: Tuple[int, ...],
                    v: Tuple[int, ...]) -> ctypes.Array:
    """The three maps' values as the C side takes them (read-only)."""
    return (ctypes.c_longlong * 33)(*q, *k, *v)


def _tma_operand(x: torch.Tensor, rows: int) -> Tuple[torch.Tensor,
                                                      Tuple[int, ...]]:
    """x as TMA reads it, with its map's values: a view is used in place
    when D is unit-stride, the other strides are multiples of 16 bytes and
    the base is 16-byte aligned; anything else is copied to a contiguous
    tensor first."""
    if x.data_ptr() % TMA_STRIDE_ALIGN == 0:
        vals = _map_values(x.shape, x.stride(), rows)
        if vals is not None:
            return x, vals
    x = _aligned(x)
    vals = _map_values(x.shape, x.stride(), rows)
    if vals is None:
        bad = tma_geometry(x.shape, x.stride(), rows).problems()
        raise ValueError(f"flash_attention: no TMA tensor map for "
                         f"{tuple(x.shape)}: {'; '.join(bad)}")
    return x, vals


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, Kv, D), H = Kv * G, float32 or
    bfloat16, D <= 128.  Returns (B, S, H, D) in q's dtype, computed by
    the body ``body(dtype, D)`` names.  Forward only: under grad mode it
    refuses q, k or v that require a gradient rather than return an
    output detached from them."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention kernel is forward-only and "
                           "got inputs that require grad; training "
                           "attention takes models.layers._chunked_gqa")
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
    scale = float(d) ** -0.5
    if body(q.dtype, d) == "wgmma":
        q, gq = _tma_operand(q, WGMMA_Q_ROWS)
        k, gk = _tma_operand(k, WGMMA_KV_ROWS)
        v, gv = _tma_operand(v, WGMMA_KV_ROWS)
        KERNEL.launch("flash_attention_wgmma", dev, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h,
                      kv, d, int(causal), scale, _geometry_array(gq, gk, gv))
        return out
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    KERNEL.launch("flash_attention", dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, s, t, h, kv, d,
                  int(causal), scale, DTYPES[q.dtype])
    return out
