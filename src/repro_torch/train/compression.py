"""int8 error-feedback gradient compression, a port of
``repro.train.compression``: each worker quantizes its local gradient to
int8 with a float32 scale per block of 256 before the all-reduce, and
keeps the quantization residual in an error buffer added back into the
next step's gradient (EF-SGD).  Rounding is half to even, as
``jnp.round``'s, so the int8 values and scales equal ``repro``'s.

Pure functions over nested dicts whose compressed leaves are (q, scale)
tuples.  ``repro``'s ``psum_compressed`` needs a collective and waits for
the port's ``torch.distributed`` meshes (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.params import (tree_flatten, tree_map,
                                       tree_unflatten)

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)), flat.shape[0]


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 values (blocks, 256), per-block float32 scales)."""
    flat, _ = _pad_to_block(g.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               n: int) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)[:n]
    return flat.reshape(shape)


def compress_tree(grads: Any, error: Any) -> Tuple[Any, Any]:
    """(grads + error) -> (compressed tree of (q, scale), new error tree).

    The returned error is the residual (g + e) - dequant(quant(g + e))."""
    def one(g, e):
        corrected = g.float() + e
        q, s = quantize(corrected)
        deq = dequantize(q, s, g.shape, g.numel())
        return (q, s), corrected - deq

    flat_g, struct = tree_flatten(grads)
    flat_e = tree_flatten(error)[0]
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(struct, [c for c, _ in out]),
            tree_unflatten(struct, [e for _, e in out]))


def decompress_tree(comp: Any, like: Any) -> Any:
    flat_c = tree_flatten(comp)[0]
    flat_g, struct = tree_flatten(like)
    return tree_unflatten(struct, [
        dequantize(q, s, g.shape, g.numel()).float()
        for (q, s), g in zip(flat_c, flat_g)])


def init_error(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
