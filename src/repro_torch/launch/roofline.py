"""Roofline terms of a dry-run cell, the port of ``repro.launch.roofline``.

Three terms per (arch x shape x mesh), in seconds:

    compute    = per-device FLOPs / peak FLOP/s, each operand type's
                 FLOPs over its own peak (bf16 on the tensor cores, TF32,
                 or float32 outside them: ``Hardware.peak_for``)
    memory     = per-device HBM bytes / HBM bandwidth
    collective = per-device wire bytes / the per-GPU link bandwidth

``repro`` reads the FLOPs and bytes from XLA and parses the collectives
out of the partitioned HLO (``parse_collectives`` / ``analyze``).  The
port has no HLO: ``launch/opcost.py`` counts all three on the ops each
device runs, and ``analyze_module_cost`` turns its ``ModuleCost`` into the
terms.  The wire factors (ring algorithms over a group of N) are
``repro``'s, in ``opcost.WIRE_FACTOR``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.launch.mesh import H100, Hardware


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    bytes_per_dev: float
    wire_bytes_per_dev: float
    coll_out_bytes_per_dev: float
    collectives: Dict[str, Dict]
    dominant: str
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze_module_cost(mc, hw: Hardware = H100) -> Roofline:
    """Roofline terms from an ``opcost.ModuleCost`` (per device)."""
    by_dtype = dict(mc.flops_by_dtype)
    terms = {
        "compute": sum(f / hw.peak_for(k) for k, f in by_dtype.items()),
        "memory": mc.hbm_bytes / hw.hbm_bw,
        "collective": mc.wire_bytes / hw.ici_bw,
    }
    dominant = max(terms, key=terms.get)
    return Roofline(
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], flops_per_dev=mc.flops,
        bytes_per_dev=mc.hbm_bytes, wire_bytes_per_dev=mc.wire_bytes,
        coll_out_bytes_per_dev=mc.coll_out_bytes,
        collectives={k: {"count": v} for k, v in mc.coll_counts.items()},
        dominant=dominant, flops_by_dtype=by_dtype)


def check_no_f64(mc) -> List[str]:
    """The ops of the counted program with a float64 output (the model
    path must not leak float64 compute)."""
    return list(mc.float64_ops)


def model_flops(cfg, shape, chips: int) -> Tuple[float, str]:
    """MODEL_FLOPS (global, matmul-only ideal): 6·N·D training,
    2·N_active·D inference (D = tokens processed per step)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n_active * d, "6*N_active*D"
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n_active * d, "2*N_active*D"
    d = shape.global_batch          # one token per sequence
    return 2.0 * n_active * d, "2*N_active*B"
