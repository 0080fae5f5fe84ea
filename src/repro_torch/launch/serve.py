"""Serving launcher: the continuous-batching engine on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-coder-33b --smoke --requests 12 [--slots 4]

``--arch`` takes any registered model (the dense, moe, vlm, ssm, hybrid
and encdec families; encdec and vlm models get a zero frontend).  Runs
on the CUDA device unless ``--device cpu`` is given.  Parameters are
drawn from a seed (no weights are downloaded)."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import api
from repro_torch.serve import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(cfg, gen)

    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_len=args.max_len, device=dev)
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        engine.submit(Request(
            rng.integers(16, cfg.vocab_size, 16).tolist(),
            max_new_tokens=args.max_new, stop_at_eos=False))
    done = engine.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.tokens) for r in done)
    print(f"{len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s) — {engine.decode_steps} decode steps "
          f"on {args.slots} slots ({dev})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
