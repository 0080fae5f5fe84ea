#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell; its
configuration, traffic mix, metric readers and limits are files under
``bench/`` found by name (``harness/cell.py``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which also end standard error.

Exit codes: 0 a result was printed (correct or not); 2 the checkout
holds no port; 3 no card, or fewer than the cell asks for; 4 JAX or the
JAX package was loaded.  No result is printed on any of these.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import env  # noqa: E402
from bench.harness.cell import Cell, load_cell  # noqa: E402


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float):
    """One run of ``cell``: its result line and the compared numbers
    (name -> [value, limit])."""
    import torch
    driver = cell.driver()
    rec = driver.run(cell, seed, seconds, trace, device, t_start)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = env.device_record(device, cell.chips)
    dev["memory_peak_bytes"] = int(rec["memory_peak_bytes"])
    tr = rec.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = driver.check(rec, device)
    checks = {}
    for name, limit in cell.limits.items():
        value = got.get(name)
        if value is not None and not math.isfinite(value):
            value = None           # no reading: JSON has no infinity
        checks[name] = [value, limit]
    correct = (rec["failed"] == 0 and
               all(v is not None and v <= lim for v, lim in checks.values()))
    line = {"correct": correct, "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics, "device": dev}
    if trace and tr is not None:
        line["breakdown"] = tr.breakdown()
    line["checks"] = checks
    return line, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        env.prepare()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    try:
        env.require_cards(cell.chips)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 3
    import torch
    line, checks = run_cell(cell, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            T_START)
    bad = env.forbidden_loaded()
    if bad:
        print(f"bench: modules that may not load were loaded: {bad}",
              file=sys.stderr)
        return 4
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
