"""Equi-join probe routed by device: CUDA tensors take the hand kernel,
CPU and meta tensors the plain version."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.hash_probe import kernel, ref


def sorted_probe(probe: torch.Tensor, ref_keys: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    if on_cuda(probe):
        return kernel.sorted_probe(probe, ref_keys)
    return ref.sorted_probe(probe, ref_keys)
