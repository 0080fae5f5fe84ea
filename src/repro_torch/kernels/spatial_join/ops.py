"""Spatial radius join routed by device: CUDA tensors take the hand
kernel, CPU and meta tensors the plain version."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.spatial_join import kernel, ref


def radius_join(px: torch.Tensor, py: torch.Tensor, rx: torch.Tensor,
                ry: torch.Tensor, radius: float, k: int,
                ref_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if on_cuda(px):
        return kernel.radius_join(px, py, rx, ry, radius, k, ref_valid)
    return ref.radius_join(px, py, rx, ry, radius, k, ref_valid)
