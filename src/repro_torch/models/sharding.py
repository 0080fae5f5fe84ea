"""Logical-axis sharding, on one device.

``repro`` maps logical axis names to mesh axes and constrains activations
with ``shard``.  The port runs one card for now, where every constraint
is the identity; device meshes over ``torch.distributed`` are ROADMAP
Queue 1 item 7.
"""

from __future__ import annotations

from typing import Optional

import torch


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The identity on one device (``repro``'s no-mesh behaviour)."""
    return x
