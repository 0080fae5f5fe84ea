"""Elastic scaling: checkpoint -> remesh -> reshard-on-restore, a port of
``repro.runtime.elastic`` over ``torch.distributed``.

A mesh is fixed for the life of a process group, so elasticity is
realized at restart boundaries: when the live process set changes,
rebuild the mesh over whatever is alive, re-derive every placement from
the *logical* axis rules (``models/sharding.py``; the rules do not depend
on the mesh's shape), and restore the latest checkpoint with each rank
taking its slice of every leaf (``ckpt.restore(..., shardings=)``).
Nothing about the model or the step changes.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models.sharding import Rules, tree_shardings


def build_mesh(devices: Optional[Sequence[int]] = None,
               model_parallel: int = 1,
               axis_names: Tuple[str, str] = ("data", "model"),
               device: DeviceLike = None):
    """A (n / model_parallel, model_parallel) ``DeviceMesh`` over the ranks
    ``devices`` (default: every rank of the live process group): the
    data dimension absorbs whatever count survives, the model dimension
    is the requested width.  Its device type is the card's unless
    ``device`` says otherwise ("cpu": gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model_parallel}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(
        n // model_parallel, model_parallel)
    return DeviceMesh(resolve_device(device).type, grid,
                      mesh_dim_names=tuple(axis_names))


def remesh_shardings(shape_tree: Any, axes_tree: Any, mesh,
                     rules: Optional[Rules] = None) -> Any:
    """``NamedSharding``s for ``shape_tree`` on a (possibly new) mesh: the
    reshard plan handed to ``ckpt.restore`` after a change of the process
    set."""
    return tree_shardings(shape_tree, axes_tree, mesh=mesh, rules=rules)
