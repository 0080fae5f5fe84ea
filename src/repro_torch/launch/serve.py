"""Serving launcher: the continuous-batching engine on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-coder-33b --smoke --requests 12 [--slots 4] \
        [--ckpt-dir DIR]

``--arch`` takes any registered model (the dense, moe, vlm, ssm, hybrid
and encdec families; encdec and vlm models get a zero frontend).  Runs
on the CUDA device unless ``--device cpu`` is given.  Parameters are
drawn from a seed (no weights are downloaded), or restored from the
latest step of ``--ckpt-dir``: a params-only restore, as ``repro``'s
launcher does, of a checkpoint holding ``{"params": ...}`` in
``repro``'s layout (either package writes it).  A directory with no
step keeps the seeded parameters."""

from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import latest_step, restore
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import api
from repro_torch.serve import Request, ServingEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the parameters from this directory's "
                         "latest step, if it has one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace
          ) -> Tuple[List[Request], ServingEngine, float]:
    """The launcher's requests, in the order submitted, once served; the
    engine; and the seconds the engine took."""
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(cfg, gen)
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        params = restore(args.ckpt_dir, {"params": params},
                         device=dev)["params"]  # params-only restore

    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_len=args.max_len, device=dev)
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    reqs = [engine.submit(Request(
        rng.integers(16, cfg.vocab_size, 16).tolist(),
        max_new_tokens=args.max_new, stop_at_eos=False))
        for _ in range(args.requests)]
    engine.run()
    return reqs, engine, time.perf_counter() - t0


def main(argv=None):
    args = parse_args(argv)
    reqs, engine, dt = serve(args)
    tokens = sum(len(r.tokens) for r in reqs)
    print(f"{len(reqs)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s) — {engine.decode_steps} decode steps "
          f"on {args.slots} slots ({engine.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
