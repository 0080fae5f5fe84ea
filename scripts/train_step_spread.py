"""How far one train step on the card lies from the same step on the CPU,
when the card is right and when it carries a planted fault: the basis of
the card-vs-CPU limits of chip_smoke.py's phase 9 (TRAIN_CHECK_TOL) and
of the bf16 case of tests/test_torch_cuda.py::
test_train_step_on_card_matches_cpu (TRAIN_TEST_TOL).

    python3 scripts/train_step_spread.py [--trials 3] [--out DIR]

Needs a CUDA device (and ~25 GB of host memory for the CPU's copy of the
1-layer state).  Two configurations, each read by
``chip_smoke.train_check_readings`` (|d loss|, |d grad_norm| / grad_norm,
the worst leaf's |d update| / |update|) from a state at step 3 with
seeded moments:

  smoke  phase 9's cross-check: deepseek-coder-33b at full width, 1 of 62
         layers, bf16, one packed row of 1,024 tokens; trial i's state
         from TRAIN_SEED + 1 + i (trial 0 is phase 9's) and its row from
         batch i of phase 9's LM data plane over the scale-1.0 tables;
  test   the test's bf16 case: the smoke deepseek-coder-33b (2 layers,
         remat "full"), a packed row of 256 tokens; trial i draws state
         and row from seed i (trial 0 is the test's).

Each runs three times on the card: as it is (sound), with the attention
output detached from q, k and v (detach: the gradient of wq, wk, wv is
zero, the forward unchanged), and with the segment mask dropped (nomask:
packed documents attend to each other).  The CPU runs once per trial,
sound.  A check fails when any reading passes its limit, so this prints
per metric the worst sound reading, and per fault each trial's readings:
a limit set passes every sound run measured and catches every faulty
trial in at least one metric.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import RefStore  # noqa: E402
from repro_torch.core.enrich import queries as Q  # noqa: E402

METRICS = ("loss", "grad_norm", "update")
FAULTS = ("detach", "nomask")


def rows_from_feed(dev, n):
    """The first packed row (CHECK_SEQ tokens) of each of n batches of
    phase 9's LM data plane."""
    from repro_torch.configs import get_config
    store = RefStore()
    Q.make_reference_tables(store, scale=1.0, seed=cs.SEED_TABLES)
    src = cs.train_source(store, dev, get_config(cs.SERVE_ARCH))
    try:
        it = iter(src)
        return [{k: v[:1, :cs.CHECK_SEQ].copy() for k, v in next(it).items()}
                for _ in range(n)]
    finally:
        src.close()


def trial(dev, row, seed, cfg=None):
    out = {}
    r, cpu = cs.train_check_readings(dev, row, seed, cfg=cfg)
    out["sound"] = r
    for fault in FAULTS:
        out[fault], _ = cs.train_check_readings(dev, row, seed, fault=fault,
                                                cpu=cpu, cfg=cfg)
    for run in out.values():
        run.pop("update_by_leaf")
    return out


def summarize(trials):
    worst = {m: max(t["sound"][m] for t in trials) for m in METRICS}
    faults = {f: [{m: t[f][m] for m in METRICS} for t in trials]
              for f in FAULTS}
    return {"worst_sound": worst, "faulty_trials": faults}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "smoke_out"))
    ap.add_argument("--only", choices=("smoke", "test"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_spread: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    res = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line()}
    print(res["nvidia_smi"], flush=True)
    if args.only in (None, "smoke"):
        # phase 9 runs its step with TF32 float32 products
        torch.backends.cuda.matmul.allow_tf32 = True
        t0 = time.perf_counter()
        rows = rows_from_feed(dev, args.trials)
        trials = []
        for i, row in enumerate(rows):
            trials.append(trial(dev, row, cs.TRAIN_SEED + 1 + i))
            print(f"smoke trial {i}: " + json.dumps(
                {k: {m: v[m] for m in METRICS} for k, v in
                 trials[-1].items()}), flush=True)
        res["smoke"] = {"trials": trials, **summarize(trials),
                        "seconds": time.perf_counter() - t0}
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.only in (None, "test"):
        cfg = smoke_config(cs.SERVE_ARCH).replace(
            remat="full", dtype="bfloat16", param_dtype="bfloat16")
        trials = []
        for i in range(args.trials):
            trials.append(trial(dev, cs.packed_row(256, seed=i), i, cfg=cfg))
            print(f"test trial {i}: " + json.dumps(
                {k: {m: v[m] for m in METRICS} for k, v in
                 trials[-1].items()}), flush=True)
        res["test"] = {"trials": trials, **summarize(trials)}
    for name in ("smoke", "test"):
        if name in res:
            print(f"{name}: " + json.dumps({k: res[name][k] for k in (
                "worst_sound", "faulty_trials")}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "train_step_spread.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
