"""int8 error-feedback gradient compression, a port of
``repro.train.compression``: each worker quantizes its local gradient to
int8 with a float32 scale per block of 256 before the all-reduce, and
keeps the quantization residual in an error buffer added back into the
next step's gradient (EF-SGD).  Rounding is half to even, as
``jnp.round``'s, so the int8 values and scales equal ``repro``'s.

Pure functions over nested dicts whose compressed leaves are (q, scale)
tuples, and ``psum_compressed``, the data-parallel mean over a
``torch.distributed`` process group that moves the int8 payloads.
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


def psum_compressed(grads: Any, error: Any, group=None) -> Tuple[Any, Any]:
    """Error-feedback compressed data-parallel mean over ``group`` (None:
    the default group): quantize locally, ``all_gather`` the int8
    payloads and the float32 scales (+1.5 %), dequantize and take the
    mean in float32, summed in rank order.  Every rank gets the exact
    mean of the ranks' *dequantized* gradients; the new error is the
    local residual."""
    import torch.distributed as dist
    comp, new_err = compress_tree(grads, error)
    n = dist.get_world_size(group)

    def gather(x):
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x.contiguous(), group=group)
        return torch.stack(out)

    def reduce_one(c, g):
        q, s = c
        per = gather(q).float() * gather(s)[:, :, None]
        mean = torch.sum(per, dim=0) / n
        return mean.reshape(-1)[:g.numel()].reshape(g.shape)

    flat_c = tree_flatten(comp)[0]
    flat_g, struct = tree_flatten(grads)
    return (tree_unflatten(struct, [reduce_one(c, g)
                                    for c, g in zip(flat_c, flat_g)]),
            new_err)
