"""Training launcher: the fault-tolerant Trainer on one card, fed by the
IDEA pipeline (UDF2 -> tokenize -> filter -> packer).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-coder-33b --smoke --steps 10 [--ckpt-dir DIR]

Runs on the CUDA device unless ``--device cpu`` is given.  One device and
no mesh: ``repro``'s ``--model-parallel`` waits for the port's
``torch.distributed`` meshes (ROADMAP Queue 1 item 7) and is refused.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import FeedManager, RefStore
from repro_torch.core.enrich import queries as Q
from repro_torch.models import api
from repro_torch.train import OptConfig
from repro_torch.train.data_feed import FeedDataSource
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # float32 products in TF32: exact for the bf16 operands of the
        # scores and the head, p rounded to 10 bits in P.V
        torch.backends.cuda.matmul.allow_tf32 = True
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} params~{api.param_count(cfg)/1e6:.1f}M "
          f"device={dev}")

    store = RefStore()
    Q.make_reference_tables(store, scale=0.002, seed=7)
    source = FeedDataSource(FeedManager(store, device=dev),
                            vocab_size=cfg.vocab_size,
                            seq_len=args.seq_len, batch_size=args.batch,
                            total_records=10_000_000, frame_size=512,
                            safety_filter=True, num_partitions=2)

    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                    total_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=5)
    try:
        trainer = Trainer(cfg, opt, tcfg, device=dev)
        history = trainer.run(iter(source))
    finally:
        source.close()
    for h in history[-5:]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"lr {h['lr']:.2e}  {h['wall_s']:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
