"""Two sets of the port's dry-run artifacts side by side, cell by cell.

    PYTHONPATH=src python scripts/dryrun_compare.py BEFORE_DIR AFTER_DIR \
        [--repro SIDE_BY_SIDE.json]

Each directory holds ``<arch>__<shape>__<mesh>.json`` artifacts of
``python -m repro_torch.launch.dryrun --all --device cpu --out DIR``
(for instance one tree's and another's).  Prints one markdown row for
each (arch, shape): per-device FLOPs, collective wire GB, the dominant
roofline term, ``useful_ratio`` and GB a device (argument + temporary +
output bytes), before -> after, single-pod mesh then multi-pod; then the
cells whose per-device FLOPs rose, whose GB a device rose, whose
dominant term changed, and whose argument bytes or fallbacks differ.
Then one row for each decode cell (decode_32k, long_500k): its
collective wire bytes a device before -> after, single-pod and
multi-pod, with ``repro``'s beside them where ``--repro`` names the
``--out`` file of ``scripts/dryrun_side_by_side.py`` that read them, and
the decode cells whose wire rose.  Exits 1 if a cell's FLOPs rose or its
argument bytes changed."""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))


def load(d: str, arch: str, shape: str, mesh: str):
    p = os.path.join(d, f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        r = json.load(fh)
    if r["status"] != "ok":
        return {"status": r["status"]}
    rf = r["roofline"]
    return {"status": "ok", "flops": rf["flops_per_dev"],
            "wire": rf["wire_bytes_per_dev"] / 1e9,
            "dominant": rf["dominant"], "useful": r["useful_ratio"],
            "gb": (r["arg_bytes_per_dev"] + r["temp_bytes_per_dev"]
                   + r["out_bytes_per_dev"]) / 1e9,
            "arg": r["arg_bytes_per_dev"], "fallbacks": r["fallbacks"]}


def main(argv=None) -> int:
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import SWEEP_ORDER
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--repro", help="scripts/dryrun_side_by_side.py's "
                                    "--out file: repro's wire bytes")
    args = ap.parse_args(argv)
    print("| cell | FLOPs/dev single | FLOPs/dev multi | wire GB/dev "
          "single; multi | dominant | useful single; multi | GB/dev "
          "single; multi |")
    print("|---|---|---|---|---|---|---|")
    rose, grew, moved, differ = [], [], [], []
    for arch in SWEEP_ORDER:
        for shape in SHAPES:
            pair = {m: (load(args.before, arch, shape, m),
                        load(args.after, arch, shape, m))
                    for m in ("single", "multi")}
            if any(b is None or a is None for b, a in pair.values()):
                continue
            if any(b["status"] != "ok" or a["status"] != "ok"
                   for b, a in pair.values()):
                print(f"| {arch} {shape} | "
                      + "; ".join(f"{b['status']} -> {a['status']}"
                                  for b, a in pair.values()) + " | | | | | |")
                continue
            for m, (b, a) in pair.items():
                cell = f"{arch} {shape} {m}"
                if a["flops"] > b["flops"]:
                    rose.append(cell)
                if round(a["gb"], 1) > round(b["gb"], 1):
                    grew.append(f"{cell} {b['gb']:.1f} -> {a['gb']:.1f}")
                if a["dominant"] != b["dominant"]:
                    moved.append(f"{cell} {b['dominant']} -> "
                                 f"{a['dominant']}")
                if a["arg"] != b["arg"] or a["fallbacks"] != b["fallbacks"]:
                    differ.append(cell)

            def two(key, fmt):
                return "; ".join(f"{fmt.format(b[key])} -> "
                                 f"{fmt.format(a[key])}"
                                 for b, a in pair.values())

            def doms():
                return "; ".join(a["dominant"] if a["dominant"] ==
                                 b["dominant"] else
                                 f"{b['dominant']} -> {a['dominant']}"
                                 for b, a in pair.values())
            (bs, as_), (bm, am) = pair["single"], pair["multi"]
            print(f"| {arch} {shape} | {bs['flops']:.4g} -> "
                  f"{as_['flops']:.4g} | {bm['flops']:.4g} -> "
                  f"{am['flops']:.4g} | {two('wire', '{:.3g}')} | {doms()} "
                  f"| {two('useful', '{:.4f}')} | {two('gb', '{:.1f}')} |")
    print("\nper-device FLOPs rose:", rose or "none")
    print("GB a device rose:", grew or "none")
    print("dominant term changed:", moved or "none")
    print("argument bytes or fallbacks differ:", differ or "none")
    decode_wire(args, SHAPES, SWEEP_ORDER)
    return 1 if rose or any(
        load(args.before, *c.split())["arg"] !=
        load(args.after, *c.split())["arg"] for c in differ) else 0


def decode_wire(args, shapes, archs) -> None:
    """The decode cells' wire bytes a device, before -> after, and
    repro's where read."""
    repro = {}
    if args.repro:
        with open(args.repro) as fh:
            for row in json.load(fh):
                r = row["repro"]
                if r.get("status") == "ok":
                    repro[row["cell"]] = r["wire_bytes_per_dev"] / 1e9
    print("\n| decode cell | wire GB/dev single: before -> after (repro) "
          "| multi: before -> after (repro) |")
    print("|---|---|---|")
    rose = []
    for arch in archs:
        for shape, spec in shapes.items():
            if spec.kind != "decode":
                continue
            parts = []
            for m in ("single", "multi"):
                b = load(args.before, arch, shape, m)
                a = load(args.after, arch, shape, m)
                if not (b and a and b["status"] == a["status"] == "ok"):
                    parts.append("-")
                    continue
                if a["wire"] > b["wire"]:
                    rose.append(f"{arch} {shape} {m}")
                rw = repro.get(f"{arch}:{shape}:{m}")
                parts.append(f"{b['wire']:.4g} -> {a['wire']:.4g}"
                             + (f" ({rw:.4g})" if rw is not None else ""))
            if parts != ["-", "-"]:
                print(f"| {arch} {shape} | " + " | ".join(parts) + " |")
    print("\ndecode wire rose:", rose or "none")


if __name__ == "__main__":
    sys.exit(main())
