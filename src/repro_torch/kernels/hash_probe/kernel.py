"""ctypes wrapper of the CUDA equi-join probe (csrc/hash_probe.cu)."""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.core.refdata import KEY_SENTINEL
from repro_torch.kernels import CudaKernel, check_same_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "hash_probe", Path(__file__).parent / "csrc" / "hash_probe.cu",
    {"sorted_probe": (_P, _P, _I, _I, ctypes.c_longlong, _P, _P, _P)})


def sorted_probe(probe: torch.Tensor, ref_keys: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probe: (B,) int64; ref_keys: (R,) int64 ascending, sentinel-padded.
    Returns (idx (B,) int32 [-1 when absent], found (B,) bool).  The
    arguments are checked before the device: outside the envelope it
    raises anywhere."""
    if probe.dtype != torch.int64 or ref_keys.dtype != torch.int64:
        raise TypeError(f"sorted_probe takes int64 keys, got "
                        f"{probe.dtype} / {ref_keys.dtype}")
    if probe.dim() != 1 or ref_keys.dim() != 1:
        raise ValueError("sorted_probe takes 1-D probe and key columns")
    b, r = probe.shape[0], ref_keys.shape[0]
    if max(b, r) >= 2**31:
        raise ValueError(f"sorted_probe: {max(b, r)} rows exceed int32 "
                         "indices")
    dev = check_same_cuda(probe, ref_keys)
    probe, ref_keys = probe.contiguous(), ref_keys.contiguous()
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    found = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        KERNEL.launch("sorted_probe", dev, probe.data_ptr(),
                      ref_keys.data_ptr(), b, r, int(KEY_SENTINEL),
                      idx.data_ptr(), found.data_ptr())
    return idx, found
