"""Training launcher: the fault-tolerant Trainer fed by the IDEA pipeline
(UDF2 -> tokenize -> filter -> packer), on one card or one rank of a
device mesh.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-coder-33b --smoke --steps 10 [--ckpt-dir DIR]

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch olmoe-1b-7b --smoke --steps 10 --model-parallel 2

Runs on the CUDA device unless ``--device cpu`` is given.  Under
``torchrun`` (or with ``RANK`` and ``WORLD_SIZE`` in the environment, and
``--init-method`` if not ``env://``) every process is one rank: NCCL on
the card, gloo on the CPU.  ``build_mesh`` lays the ranks out as (world /
model_parallel, model_parallel).  Every published config trains on
``repro``'s production layout, as ``repro``'s launcher trains it: its
state DTensors sharded FSDP-style over "data", tensor- and
expert-parallel over "model" (``layout=production``; a config that
sets ``moe_ep`` routes its MoE tokens by explicit hops over "model" on
that layout).  Rank 0 runs the LM
data plane and broadcasts each global batch (with two feed partitions
the row order is not promised to be the same across processes, so the
ranks do not each run a feed); each rank wraps its own rows of it.
Without that environment it is world size 1 and no mesh
(``layout=none``).
"""

from __future__ import annotations

import argparse
import os

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import api
from repro_torch.models.sharding import DEFAULT_RULES, sharding_ctx
from repro_torch.runtime.elastic import build_mesh
from repro_torch.train import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def feed_source(cfg, dev, seq_len: int, batch: int):
    """The LM data plane over small reference tables, on ``dev``."""
    from repro_torch.core import FeedManager, RefStore
    from repro_torch.core.enrich import queries as Q
    from repro_torch.train.data_feed import FeedDataSource
    store = RefStore()
    Q.make_reference_tables(store, scale=0.002, seed=7)
    return FeedDataSource(FeedManager(store, device=dev),
                          vocab_size=cfg.vocab_size, seq_len=seq_len,
                          batch_size=batch, total_records=10_000_000,
                          frame_size=512, safety_filter=True,
                          num_partitions=2)


def broadcast_batches(source, rank: int):
    """Rank 0's batches from ``source`` on every rank, until it ends."""
    import torch.distributed as dist
    it = iter(source) if rank == 0 else None
    while True:
        box = [next(it, None) if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return
        yield box[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--init-method", default="env://",
                    help="torch.distributed rendezvous of the ranks "
                         "(under RANK / WORLD_SIZE)")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    dev = resolve_device(args.device)
    ranked = "WORLD_SIZE" in os.environ
    if ranked:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=args.init_method, rank=rank,
                                world_size=world)
    elif args.model_parallel != 1:
        ap.error(f"--model-parallel {args.model_parallel} needs that many "
                 "ranks: run under torchrun (RANK / WORLD_SIZE)")
    rank = dist.get_rank() if ranked else 0
    if dev.type == "cuda":
        # float32 products in TF32: exact for the bf16 operands of the
        # scores and the head, p rounded to 10 bits in P.V
        torch.backends.cuda.matmul.allow_tf32 = True
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = build_mesh(model_parallel=args.model_parallel, device=dev) \
        if ranked else None
    if rank == 0:
        shape = "none" if mesh is None else dict(
            zip(mesh.mesh_dim_names, mesh.shape))
        layout = "none" if mesh is None else "production"
        print(f"arch={cfg.name} params~{api.param_count(cfg)/1e6:.1f}M "
              f"device={dev} mesh={shape} moe_ep={cfg.moe_ep} "
              f"layout={layout}", flush=True)

    source = feed_source(cfg, dev, args.seq_len, args.batch) \
        if rank == 0 else None
    batches = broadcast_batches(source, rank) if ranked else iter(source)
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                    total_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=5)
    try:
        # every rank takes as many batches as the others: the run ends on
        # the same step everywhere, or on the end rank 0 broadcast
        with sharding_ctx(mesh, DEFAULT_RULES):
            trainer = Trainer(cfg, opt, tcfg, device=dev, mesh=mesh)
            history = trainer.run(batches)
    finally:
        if source is not None:
            source.close()
        if ranked:
            dist.destroy_process_group()
    if rank == 0:
        for h in history[-5:]:
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
                  f"lr {h['lr']:.2e}  {h['wall_s']:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
