"""repro_torch — the PyTorch/CUDA port of ``repro`` (An IDEA's ingestion
and enrichment framework) for NVIDIA Hopper.

The package mirrors ``repro`` module for module.  It imports torch and
numpy, never jax and nothing of ``repro``.  There is no global dtype
switch: int64 keys and hashes are native torch dtypes.

Entry points (``FeedManager``, ``ComputingRunner``) take a ``device``.
``None`` means the card: without a CUDA device they raise instead of
dropping to the CPU.  Callers that want the CPU (the tests) say so with
``device="cpu"``; there every hand kernel's plain PyTorch version runs.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``.  A CUDA device without a card raises — the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev
