#!/usr/bin/env python3
"""Run one cell several times, one process a run, and report how far its
metrics spread: the spread of a metric is the distance between its first
and third quartile (``statistics.quantiles(values, n=4)``) over its
median.  The bounds in ``BENCHMARK.json`` are set from such sets.

    python3 bench/spread.py --workload <name> --seeds 1,2,3 \
        --seconds 30 [--trace 1] [--out runs.jsonl]

Each run's exit code, result line and last lines of standard error go to
``--out`` (one JSON object a run), the summary to standard output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": p.returncode, "wall_s": wall, "result": result,
            "stderr_tail": p.stderr[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for s in args.seeds.split(","):
        r = one_run(args.workload, int(s), args.seconds, args.trace)
        runs.append(r)
        res = r["result"] or {}
        print(json.dumps({"seed": r["seed"], "rc": r["rc"],
                          "wall_s": round(r["wall_s"], 1),
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in
                                      res.get("metrics", {}).items()},
                          "checks": res.get("checks")}), flush=True)
        if r["rc"] != 0 or not res:
            print(r["stderr_tail"], flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    names = sorted({k for r in runs if r["result"]
                    for k in r["result"]["metrics"]})
    for k in names:
        vals = [r["result"]["metrics"][k]["value"] for r in runs
                if r["result"] and k in r["result"]["metrics"]]
        print(json.dumps({"metric": k, "median": statistics.median(vals),
                          "spread": spread(vals), "values": vals}))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
