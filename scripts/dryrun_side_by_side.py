"""One dry-run cell in both packages, side by side: ``repro``'s
(``repro.launch.dryrun.run_cell``: XLA's SPMD partitioner on 512
placeholder CPU devices, costed by ``hlocost``) and the port's
(``repro_torch.launch.dryrun.run_cell``: DTensor over a fake process
group, costed by ``opcost``), each in its own interpreter.

    PYTHONPATH=src python scripts/dryrun_side_by_side.py \\
        mamba2-130m:decode_32k:single [ARCH:SHAPE:MESH ...] [--out FILE] \\
        [--cfg '{"moe_ep": true}']

Prints per-device counts only (argument and temporary bytes, FLOPs, HBM
bytes, collective wire bytes and counts, ``useful_ratio`` = model FLOPs /
(per-device FLOPs x chips), and the port's heaviest matmuls by local
shapes and heaviest collectives by kind, group size and output shape,
``top_flops`` and ``top_wire``): they depend on the partitioned program,
not on a chip.
``repro``'s roofline seconds are for its TPU model and are not printed.
``repro``'s artifacts go to a temporary directory, never to its
``launch_artifacts/dryrun/``.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REPRO = """
import json, sys
from repro.launch import dryrun as JD   # sets its placeholder devices
JD.ART_DIR = {tmp!r}
r = JD.run_cell({arch!r}, {shape!r}, {multi}, verbose=False,
                cfg_overrides={cfg!r})
print(json.dumps(r))
"""

_PORT = """
import json
from repro_torch.launch import dryrun as TD
r = TD.run_cell({arch!r}, {shape!r}, {multi}, verbose=False, device="cpu",
                cfg_overrides={cfg!r})
print(json.dumps(r))
"""


def _run(code: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def counts(r: dict) -> dict:
    if r["status"] != "ok":
        return {"status": r["status"]}
    rf = r["roofline"]
    colls = {k: v["count"] for k, v in rf["collectives"].items()}
    return {"status": "ok", "chips": r["chips"],
            "arg_bytes_per_dev": r["arg_bytes_per_dev"],
            "temp_bytes_per_dev": r["temp_bytes_per_dev"],
            "flops_per_dev": rf["flops_per_dev"],
            "hbm_bytes_per_dev": rf["bytes_per_dev"],
            "wire_bytes_per_dev": rf["wire_bytes_per_dev"],
            "collectives": colls, "fallbacks": len(r["fallbacks"]),
            "useful_ratio": r["useful_ratio"],
            **{k: r[k] for k in ("top_flops", "top_wire") if k in r}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+", help="ARCH:SHAPE:MESH")
    ap.add_argument("--out", help="write the rows as JSON here too")
    ap.add_argument("--cfg", default=None,
                    help='JSON ModelConfig overrides for both packages, '
                         'e.g. {"moe_ep": true}')
    args = ap.parse_args(argv)
    cfg = json.loads(args.cfg) if args.cfg else None
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for cell in args.cells:
            arch, shape, mesh = cell.split(":")
            kw = dict(arch=arch, shape=shape, multi=mesh == "multi",
                      tmp=tmp, cfg=cfg)
            rows.append({"cell": cell,
                         "repro": counts(_run(_REPRO.format(**kw))),
                         "port": counts(_run(_PORT.format(**kw)))})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
