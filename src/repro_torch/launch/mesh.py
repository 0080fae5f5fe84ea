"""Production mesh and the H100 hardware model, the port of
``repro.launch.mesh``.

``make_production_mesh`` is a function (not a module constant), so that
importing this module touches no process group: the dry run opens a
fake one of 256 or 512 ranks first (``fake_process_group``), and
everything else sees whatever group its own launcher made.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence, Tuple


def production_layout(multi_pod: bool = False
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``repro``'s production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the live process
    group (its world size must be the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape, axes = production_layout(multi_pod)
    return make_mesh(shape, axes, device)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A process group of ``world_size`` ranks that this process holds
    alone, as rank 0: torch's "fake" backend, whose collectives return at
    once and move no data.  A process group is process-wide, so this is
    for the dry run's own process: it refuses to stack on a live group
    and destroys its own on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already live in this "
                           "process; the dry run needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Hardware:
    """NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no
    sparsity, at the full 700 W power limit; a card set lower runs
    slower under load):

    * ``peak_flops``: 989 TFLOP/s of bf16 on the tensor cores;
      ``peak_tf32_flops``: 494.5 TFLOP/s of TF32 on them;
      ``peak_f32_flops``: 67 TFLOP/s of float32 outside them (the data
      sheet's float64 tensor-core rate is the same 67);
    * ``hbm_bw``: 3.35 TB/s of HBM3; ``hbm_bytes``: 80 GB;
    * ``ici_bw``: NVLink 4, 450 GB/s each way per GPU, in the role
      ``repro``'s TPU model gives its inter-chip link.  One NVLink domain
      holds 8 GPUs: a 16-wide mesh axis spans two nodes, whose traffic
      crosses the slower network between them, so there the collective
      term is a lower bound.
    """
    name: str = "h100-sxm"
    peak_flops: float = 989e12
    peak_f32_flops: float = 67e12
    hbm_bw: float = 3.35e12
    ici_bw: float = 450e9
    hbm_bytes: float = 80e9
    peak_tf32_flops: float = 494.5e12

    def peak_for(self, kind: str) -> float:
        """The peak FLOP/s of matmuls in ``kind`` (``opcost.flop_kind``):
        16-bit types on the tensor cores, TF32, else float32's."""
        if kind in ("bfloat16", "float16"):
            return self.peak_flops
        if kind == "tf32":
            return self.peak_tf32_flops
        return self.peak_f32_flops


H100 = Hardware()
