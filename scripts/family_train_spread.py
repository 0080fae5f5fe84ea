"""How far one train step of each family on the card lies from the same
step on the CPU, when the card is right and when it carries a planted
fault: the basis of chip_smoke.py's phase 15 limits (FAMILY_TRAIN_TOL).

    python3 scripts/family_train_spread.py [--trials 3] [--out DIR]
        [--families moe,ssm,vlm,encdec]

Needs a CUDA device (and ~15 GB of host memory for the CPU's copy of
olmoe's 1-layer state).  Per family, ``chip_smoke.family_step_readings``
reads |d loss|, |d grad_norm| / grad_norm and the worst leaf's |d update|
/ |update| after one step of phase 15's check model (FAMILY_TRAIN's
check_layers at full width, check_seq positions of one packed row of
the LM data plane over the scale-1.0 tables, seeded frontend rows for
vlm and encdec) from a state at step 3 with seeded moments, with TF32
on as in phase 15.  Trial i takes its state from TRAIN_SEED + 1 + i and
its row from batch i of the data plane (trial 0 is phase 15's).

Each trial runs on the card as it is (sound) and with each of the
family's two faults (FAMILY_TRAIN_FAULTS) planted; the CPU runs once per
trial, sound.  A check fails when any reading passes its limit, so this
prints per metric the worst sound reading, and per fault each trial's
readings: a limit set passes every sound run measured and catches every
faulty trial in at least one metric.  A NaN reading prints as inf.
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
from repro_torch.core import RefStore  # noqa: E402
from repro_torch.core.enrich import queries as Q  # noqa: E402

METRICS = ("loss", "grad_norm", "update")


def family(fam, dev, store, trials):
    cfg = cs.family_train_cfg(fam, cs.FAMILY_TRAIN[fam]["check_layers"])
    out = []
    for i in range(trials):
        row = cs.family_check_row(fam, store, dev, cfg, seed=i)
        runs = {}
        runs["sound"], cpu = cs.family_step_readings(
            fam, dev, row, cs.TRAIN_SEED + 1 + i)
        for fault in cs.FAMILY_TRAIN_FAULTS[fam]:
            runs[fault], _ = cs.family_step_readings(
                fam, dev, row, cs.TRAIN_SEED + 1 + i, fault=fault, cpu=cpu)
        del cpu
        out.append(runs)
        print(f"{fam} trial {i}: " + json.dumps(
            {k: {m: v[m] for m in METRICS} for k, v in runs.items()}),
            flush=True)
    worst = {m: max(t["sound"][m] for t in out) for m in METRICS}
    faults = {f: [{m: t[f][m] for m in METRICS} for t in out]
              for f in cs.FAMILY_TRAIN_FAULTS[fam]}
    return {"trials": out, "worst_sound": worst, "faulty_trials": faults}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "smoke_out"))
    ap.add_argument("--families", default=",".join(cs.FAMILY_TRAIN))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("family_train_spread: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = True      # as phase 15
    res = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line()}
    print(res["nvidia_smi"], flush=True)
    store = RefStore()
    Q.make_reference_tables(store, scale=1.0, seed=cs.SEED_TABLES)
    for fam in args.families.split(","):
        t0 = time.perf_counter()
        res[fam] = family(fam, dev, store, args.trials)
        res[fam]["seconds"] = time.perf_counter() - t0
        print(f"{fam}: " + json.dumps({k: res[fam][k] for k in (
            "worst_sound", "faulty_trials")}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "family_train_spread.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
