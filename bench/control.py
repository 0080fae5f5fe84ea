#!/usr/bin/env python3
"""The readings that the limits in ``bench/limits/`` are set from, on the
card at the cell's own size: for each seed, the numbers ``correct``
compares for the program as it is (the lower readings), for the control
(the reference in float8 e4m3 put in the program's place: the step below
the bfloat16 the configurations compute in), and with a fault planted
in the program's timed path.

    python3 bench/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 8] [--fault none|token|half_batch|frozen_state] \
        [--control 1]

Training needs no window (``--seconds 0``: the three checked steps are
set-up); serving a short one at the cell's own load.  One process for
every seed; one JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import env  # noqa: E402


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted in its timed path:
      token         each served token one above what the engine chose, or
                    each packed batch's first token altered
      half_batch    every training step on the first half of its rows
      frozen_state  every training step returns its state unchanged
    """
    if fault == "none":
        yield
        return
    from repro_torch.data import packing
    from repro_torch.serve import engine
    from repro_torch.train import steps
    saved = []

    def patch(obj, name, fn):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    if fault == "token":
        step, emit = engine.ServingEngine.step, packing.StreamPacker._emit

        def bad_step(self):
            out = step(self)
            for req in list(self.completed) + [r for r in self.active if r]:
                if req.tokens and not getattr(req, "_bent", 0) == len(
                        req.tokens):
                    req.tokens[-1] = (req.tokens[-1] + 1) % self.cfg.vocab_size
                    req._bent = len(req.tokens)
            return out

        def bad_emit(self):
            out = emit(self)
            out["tokens"][0, 1] ^= 1        # ids >= 16 stay in the vocab
            return out
        patch(engine.ServingEngine, "step", bad_step)
        patch(packing.StreamPacker, "_emit", bad_emit)
    elif fault == "half_batch":
        acc = steps.TrainStep.accumulate

        def half(self, params, batch):
            n = batch["tokens"].shape[0] // 2
            return acc(self, params, {k: v[:n] for k, v in batch.items()})
        patch(steps.TrainStep, "accumulate", half)
    elif fault == "frozen_state":
        def frozen(self, state, loss, metrics, grads):
            return state, {"loss": loss, **{k: v for k, v in metrics.items()
                                            if k != "loss"}}
        patch(steps.TrainStep, "update", frozen)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--fault", default="none")
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    env.prepare()
    import torch
    from bench.harness.cell import load_cell
    cell = load_cell(args.workload)
    driver = cell.driver()
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with planted(args.fault):
            rec = driver.run(cell, seed, args.seconds, False, dev, t0)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "program": driver.check(rec, dev), "failed": rec["failed"],
               "attempted": rec["attempted"]}
        if args.control:
            out["control"] = driver.check(rec, dev, precision="fp8")
        out["wall_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del rec
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
