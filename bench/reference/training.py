"""The training cells' reference: the data plane and the model follow the
program's first three steps from the same records, tables and weights,
and what the program produced is judged against them.

Numbers (each beside its limit in the result):

  batch_mismatch  positions of the three packed batches where any field
                  differs from the reference's packing (exact: limit 0)
  loss_tokens_gap the largest gap between the loss tokens a step counted
                  and the reference batch's (exact: limit 0)
  loss_gap        the largest |loss - reference loss| / reference loss
                  over the steps (the third step's loss, after the first
                  update, is several times the first's on these models)
  grad_norm_gap   the first gradient as the optimizer took it (its first
                  moment after step 1 over 1 - b1, clipped), the worst
                  leaf's |norm - reference norm| over the larger of the
                  reference's norm of that leaf and of the median leaf
  update_gap      the same of each leaf's change over the three steps

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both gaps.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench.reference import adamw, data_plane, model

NEGLIGIBLE = 1e-3


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def worst_gap(got: List[float], want: List[float],
              keep: List[bool]) -> float:
    floor = statistics.median(w for w, k in zip(want, keep) if k)
    return max(abs(g - w) / max(w, floor)
               for g, w, k in zip(got, want, keep) if k)


def reference_batches(run: Dict, want: int) -> List[Dict[str, np.ndarray]]:
    """The first ``want`` batches the reference packs from the run's
    records in the run's arrival order."""
    cf, tr = run["config"], run["traffic"]
    records = data_plane.Records(run["stream_seed"], run["frame_size"],
                                 run["total"])
    return data_plane.packed_batches(
        run["arrivals"], records, run["table"], int(cf["vocab_size"]),
        int(tr["seq"]), int(tr["rows"]), want)


def train_steps(cf: Dict, fresh: Callable[[], Dict], batches: List[Dict],
                opt: Dict, precision: str, device,
                stored: Optional[List[str]] = None) -> Dict:
    """Losses, first clipped gradient norms and the change of each leaf
    over ``batches`` (one step each), from the float32 weights ``fresh()``
    returns (called twice: to train and to measure the change).  With
    ``precision`` "fp8", ``stored`` names each leaf's configured dtype
    and the leaf is held one step below it, from the start and after
    every update."""
    dm = model.Dims(cf)

    def held(tree):
        leaves = _leaves(tree)
        if precision != "float32":
            with torch.no_grad():
                for p, dt in zip(leaves, stored):
                    p.copy_(model.stored(p, dt))
        return leaves

    params = fresh()
    leaves = [p.requires_grad_() for p in held(params)]
    opt_state = adamw.AdamW(opt, leaves)
    losses, first = [], None
    for batch in batches:
        b = {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in batch.items()}
        total, _ = model.loss(dm, params, b, precision)
        grads = torch.autograd.grad(total, leaves)
        losses.append(float(total.detach()))
        used = opt_state.step(list(grads))
        held(params)
        del grads, total
        if first is None:
            first = used
    del opt_state
    changes = [float(torch.linalg.vector_norm(p.detach() - s))
               for p, s in zip(leaves, held(fresh()))]
    return {"losses": losses, "grad_norms": first, "changes": changes}
