"""Render the port's dry-run artifacts as a table.

    PYTHONPATH=src python -m repro_torch.launch.report [--tags] > table.md

The port of ``repro.launch.report``: the same rows from
``launch_artifacts/dryrun_torch/*.json``, with ``hbm_fit`` read against
the H100's 80 GB.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "launch_artifacts", "dryrun_torch")


def load(tags: bool = False, art: str = ART):
    rows = []
    for p in sorted(glob.glob(os.path.join(art, "*.json"))):
        with open(p) as fh:
            r = json.load(fh)
        tagged = "@" in r.get("mesh", "")
        if tagged != tags:
            continue
        rows.append(r)
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    rows.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9),
                             r["mesh"]))
    return rows


def fmt_row(r) -> str:
    cell = f"{r['arch']} | {r['shape']} | {r['mesh']}"
    if r["status"] == "skip":
        return f"| {cell} | skip | — | — | — | — | — | — | {r['reason']} |"
    if r["status"] != "ok":
        return (f"| {cell} | **{r['status']}** | — | — | — | — | — | — | "
                f"{r.get('error', '')[:60]} |")
    rf = r["roofline"]
    gb = (r["arg_bytes_per_dev"] + r["temp_bytes_per_dev"]
          + r["out_bytes_per_dev"]) / 1e9
    dom = rf["dominant"]
    bound = rf[f"{dom}_s"]
    frac = rf["compute_s"] / bound if bound else 0.0
    note = "" if r["hbm_fit"] else "**over HBM**"
    return (f"| {cell} | ok | {rf['compute_s']:.4f} | {rf['memory_s']:.4f} "
            f"| {rf['collective_s']:.4f} | {dom} | {frac:.3f} "
            f"| {gb:.1f} | {note} |")


HEADER = ("| arch \\| shape \\| mesh | status | compute s | memory s | "
          "collective s | dominant | roofline frac | GB/dev | notes |\n"
          "|---|---|---|---|---|---|---|---|---|")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tags", action="store_true",
                    help="show tagged (variant) artifacts instead")
    ap.add_argument("--art", default=ART,
                    help="the artifact directory")
    args = ap.parse_args(argv)
    rows = load(tags=args.tags, art=args.art)
    print(HEADER)
    for r in rows:
        print(fmt_row(r))
    ok = [r for r in rows if r["status"] == "ok"]
    if ok:
        fits = sum(1 for r in ok if r["hbm_fit"])
        print(f"\n{len(ok)} traced, {fits} fit in 80 GB HBM/GPU; "
              f"{sum(1 for r in rows if r['status'] == 'skip')} skipped "
              f"(long_500k on full-attention archs).")


if __name__ == "__main__":
    main()
