"""Plain PyTorch version of the equi-join probe (searchsorted form — the
same semantics as the CUDA kernel, bit for bit)."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.refdata import KEY_SENTINEL


def sorted_probe(probe: torch.Tensor, ref_keys: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probe: (B,) int64; ref_keys: (R,) int64 ascending, sentinel-padded.
    Returns (idx (B,) int32 [-1 when absent], found (B,) bool)."""
    r = ref_keys.shape[0]
    if r == 0:
        return (torch.full(probe.shape, -1, dtype=torch.int32,
                           device=probe.device),
                torch.zeros(probe.shape, dtype=torch.bool,
                            device=probe.device))
    idx = torch.searchsorted(ref_keys, probe)
    idx = torch.clamp(idx, max=r - 1)
    found = (ref_keys[idx] == probe) & (probe != KEY_SENTINEL)
    return torch.where(found, idx, -1).to(torch.int32), found
