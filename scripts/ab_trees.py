"""Time the port from two source trees in turns on one CUDA card.

    python3 scripts/ab_trees.py --base DIR
        [--what kernels|paths|both|families|production]
                                [--turns base,this,this,base] [--out FILE]

DIR is another checkout of this repository (for example an unpacked
``git archive`` of the parent commit).  Turns run in the order --turns
gives (by default base, this, this, base), each in its own process: this
checkout's ``chip_smoke.py`` functions drive that tree's
``src/repro_torch`` (kernels built from its sources into its own build
directory).  ``--turns base`` measures the other tree alone.

  kernels  phase 3's sorted_probe, radius_join, segment_sum and
           segment_topk checks at every case (each result held to the
           plain version, then timed), the empty kernel's launch floor,
           and the profiled segment_topk and radius_join launch checks,
           which are reported and do not fail the turn;
  paths    the feed (``run_feed``: 20 x 6,720 tweets at scale 1.0) and
           serving (``serve_path``: deepseek-coder-33b at full width, 4
           layers, 12 requests);
  families phases 11 and 10's serving (mamba2-130m and olmoe-1b-7b
           whole, their requests) and phase 15's Trainer for the same
           two families (full width, olmoe cut to 4 of 16 layers), the
           card-vs-CPU checks left out;
  production phase 19 (a): olmoe-1b-7b at full width, 4 of 16 layers,
           3 Trainer steps on the production layout of a (1, 1) mesh
           (an NCCL group of one rank) beside the plain Trainer, TF32
           on, without the profiled step.

A tree whose segment_sum wrapper has no count mode counts through a column
of ones, as its dispatch layer did.  Prints the card's name and power
limit, then one JSON line per turn; all turns also go to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree: str, what: str) -> dict:
    sys.path[:0] = [HERE, os.path.join(tree, "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build_all
    from repro_torch.kernels.segment_reduce import kernel as srk
    if not hasattr(srk, "segment_count"):
        srk.segment_count = lambda seg, s: srk.segment_sum(
            torch.ones(seg.shape, dtype=torch.int32, device=seg.device),
            seg, s)
    build_all()
    dev = torch.device("cuda", 0)
    out = {}
    if what in ("kernels", "both"):
        rng = np.random.default_rng(2019)
        sp = cs.check_sorted_probe(dev, rng)
        sj = cs.check_radius_join(dev, rng)
        out["launch_floor_ms"] = sp["launch_floor_ms"]
        out["sorted_probe"] = sp["by_case"]
        out["radius_join"] = sj["by_case"]
        try:
            cs.check_spatial_launches(sj["by_case"])
            out["spatial_launches"] = "ok"
        except AssertionError as e:
            out["spatial_launches"] = str(e)
        out["segment_sum"] = cs.check_segment_sum(dev, rng)["by_case"]
        out["segment_topk"] = cs.check_segment_topk(dev, rng)["by_case"]
        try:
            out["topk_launches"] = cs.check_topk_launches(dev, rng)
        except AssertionError as e:
            out["topk_launches"] = str(e)
    if what in ("paths", "both"):
        from repro_torch.configs import get_config
        from repro_torch.core import RefStore
        from repro_torch.core.enrich import queries as Q
        from repro_torch.models import api
        store = RefStore()
        Q.make_reference_tables(store, scale=1.0, seed=cs.SEED_TABLES)
        _, out["feed"] = cs.run_feed(dev, store)
        cfg = get_config(cs.SERVE_ARCH).replace(num_layers=cs.SERVE_LAYERS)
        params = api.init_params(
            cfg, torch.Generator(device=dev).manual_seed(cs.SERVE_SEED))
        cs.serve_warmup(cfg, params, dev)
        out["serve"] = cs.serve_path(cfg, params, dev)
    if what == "families":
        import gc

        from repro_torch.core import RefStore
        from repro_torch.core.enrich import queries as Q
        store = RefStore()
        Q.make_reference_tables(store, scale=1.0, seed=cs.SEED_TABLES)
        for fam in ("ssm", "moe"):
            spec = cs.FAMILY_SERVE[fam]
            cfg, params, _ = cs.family_model(fam, dev)
            cs.serve_warmup(cfg, params, dev)
            reqs = cs.serve_requests(
                cfg, spec["requests"], spec["new"], spec["multiple"],
                spec.get("prompt_len", cs.SERVE_PROMPT_LEN))
            s = cs.serve_path(cfg, params, dev, reqs, tag=f"serve {fam}",
                              max_len=spec.get("max_len", cs.SERVE_MAX_LEN))
            out[f"serve_{fam}"] = {k: s[k] for k in (
                "decode_ms_per_step", "new_tokens_per_s",
                "prefill_ms_per_request")}
            del params
            gc.collect()
            torch.cuda.empty_cache()
            # TF32 on for training, off for serving, as chip_smoke runs
            torch.backends.cuda.matmul.allow_tf32 = True
            r, _ = cs.family_train(fam, dev, store, check=False)
            torch.backends.cuda.matmul.allow_tf32 = False
            out[f"train_{fam}"] = {k: r[k] for k in (
                "step_ms_median", "forward_backward_ms_median",
                "optimizer_ms_median", "tokens_per_s")}
    if what == "production":
        import tempfile

        import torch.distributed as dist

        from repro_torch.core import RefStore
        from repro_torch.core.enrich import queries as Q
        from repro_torch.runtime.elastic import build_mesh
        store = RefStore()
        Q.make_reference_tables(store, scale=1.0, seed=cs.SEED_TABLES)
        torch.backends.cuda.matmul.allow_tf32 = True
        with tempfile.TemporaryDirectory() as d:
            dist.init_process_group("nccl", init_method="file://" + d
                                    + "/pg", rank=0, world_size=1)
            try:
                spec = cs.FAMILY_TRAIN["moe"]
                r = cs.moe_production_run(
                    dev, store, build_mesh(model_parallel=1, device=dev),
                    cs.family_train_cfg("moe"), spec["seq"], spec["batch"],
                    "moe production (a)", profile=False)
            finally:
                dist.destroy_process_group()
        out["production_step_s"] = r["production"]["step_s"]
        out["plain_step_s"] = r["plain"]["step_s"]
        out["bit_equal"] = r["bit_equal"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="the other checkout's root")
    ap.add_argument("--what", default="both",
                    choices=("kernels", "paths", "both", "families",
                             "production"))
    ap.add_argument("--turns", default="base,this,this,base",
                    help="comma-separated order of the trees' turns")
    ap.add_argument("--out", default=None, help="JSON file of all turns")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        res = child(args.child, args.what)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"base": os.path.abspath(args.base), "this": HERE}
    turns = []
    for name in args.turns.split(","):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--base", args.base, "--what", args.what,
                            "--child", trees[name]],
                           capture_output=True, text=True, timeout=1800)
        found = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode or not found:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return 1
        turn = {"tree": name, **json.loads(found[0][len("RESULT "):])}
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"device": smi, "turns": turns}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
