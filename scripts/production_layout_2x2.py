"""The trainer's production layout on a 2 x 2 mesh of gloo processes on
the CPU, held to the same step in one process.

    PYTHONPATH=src python scripts/production_layout_2x2.py [--out DIR] \
        [--cases olmoe,jamba]

Starts 4 ranks of this script (gloo over a file store in DIR, no port).
For each case (smoke widths; by default CASES: deepseek-coder-33b, also
over 2 microbatches; mamba2-130m with the factored second moment;
internvl2-2b; whisper-medium; ``--cases`` names others, MOE_CASES
among them: olmoe-1b-7b over 4 rows of 1,040 tokens, so each row routes
on its own, jamba-1.5-large-398b over 4 rows of 32, routed as one
group, every period checkpointed as its published config does, and
olmoe-1b-7b with ``moe_ep`` over 4 rows of 32, its MoE layers routed by
explicit hops over "model" at capacity 8.0, where nothing drops) every
rank reads one train state and one batch from
DIR/<case>/in and DIR/<case>/batch.npz, restores the state onto
``train_shardings`` of a (2, 2) ("data", "model") mesh and runs one
``TrainStep`` on it, then the same step in one process without a mesh.
Where DIR holds no inputs they are made from seeds first: the port's
init with non-zero moments at step 3, and a batch of 4 rows whose mask
counts are 30, 27, 5 and 0 of 32 (a mean of per-rank means would be
far off; a longer row keeps as large a share).  An MoE case's last two
rows (but a ``moe_ep`` case's) are one token over and over, so that its
experts overflow at the config's own capacity factor.  The production step's new state is
saved to DIR/<case>/out and its metrics to DIR/<case>/metrics.npz, so a
caller can hold them to another reference too; an MoE case (but a
``moe_ep`` one) also saves the router logits of every MoE call of the
production step (whole, the forward's first) to DIR/<case>/router.npz.

Rank 0 prints, as its last line, one JSON object: ``torch`` (the
version: DTensor's strategies differ between versions), and per case
the largest |difference| of the loss and each metric and, over the
leaves, of the new parameters, m and v, each divided by the largest
|value| of the one-process result; every rank's count of leaves sharded
over "data" and over "model"; every rank's local state bytes beside
``launch/dryrun.py::operand_layout``'s for the mesh; every rank's
matmul FLOPs of the step (``launch/opcost.OpCounter`` below DTensor)
beside the one-process step's, which an ideal split would divide by 4,
and rank 0's ratio to that quarter (``flops_ratio``); for an MoE case
whether every layer's expert choices and kept pairs equal the
one-process step's (integers, exactly) and the pairs dropped for
capacity out of those routed (over every MoE call of the step, a
checkpointed layer's recompute included), for a ``moe_ep`` case the
all-to-alls rank 0 ran instead; and ``ok``.  The exit code
is 0 when every reading is within its case's limits (``tol``), every
rank shards a leaf over each axis, every rank's bytes are the dry
run's, an MoE case routes as one process does (a ``moe_ep`` case
through its hops), and rank 0's
``flops_ratio`` is within ``flops_limit``: at most FLOPS_RATIO_MAX, and
no more than the case read before each weight was placed at its use
(FLOPS_RATIO_BEFORE, by torch version).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))

WORLD = 4
MESH = (2, 2)
# (name, arch, microbatches, optimizer overrides)
CASES = [
    ("deepseek", "deepseek-coder-33b", 1, {}),
    ("deepseek_microbatches", "deepseek-coder-33b", 2, {}),
    ("mamba2_factored_v", "mamba2-130m", 1, {"factored_v": True}),
    ("internvl2", "internvl2-2b", 1, {}),
    ("whisper", "whisper-medium", 1, {}),
]
MOE_CASES = [
    ("olmoe", "olmoe-1b-7b", 1, {}),
    ("jamba", "jamba-1.5-large-398b", 1, {}),
    ("olmoe_ep", "olmoe-1b-7b", 1, {}),
]
ALL_CASES = {c[0]: c for c in CASES + MOE_CASES}
# positions a row: olmoe's 4 x 1,040 tokens are above the 4,096 that
# one routing group takes, so each row routes on its own
CASE_SEQ = {"olmoe": 1040}
# config changes of a case: jamba checkpoints every period, its
# published remat policy, so its MoE layers recompute under DTensor;
# olmoe_ep routes by moe_ep's explicit hops (models/moe_ep.py) at a
# capacity where no pair drops, against the one process's moe_ffn
CASE_CFG = {"jamba": {"remat": "full"},
            "olmoe_ep": {"moe_ep": True, "capacity_factor": 8.0}}


def case_config(name: str):
    """The smoke config of case ``name``, with its CASE_CFG changes."""
    from repro_torch.configs import smoke_config
    return smoke_config(ALL_CASES[name][1]).replace(
        **CASE_CFG.get(name, {}))


OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=50, weight_decay=0.01)
# float32 at smoke widths; the sharded step sums in other orders (the
# loss's mask count and cross-entropy over the data ranks, the row-
# and column-parallel products over the model ranks).  Each reading is
# |production - one process| / max |one process|.  Measured on the CPU
# (torch 2.13.0+cpu), the largest over deepseek, its microbatches,
# mamba2 and internvl2: loss 7.6e-8, grad_norm 1.7e-6, params 4.4e-8,
# m 3.9e-6, v 1.9e-6.  whisper's gradient is the sensitive one: its
# one-process float32 gradient is itself 3.5e-4 (median over the leaves)
# from the same step in float64, and the production step reads
# grad_norm 3.5e-5, m 1.6e-4, v 5.8e-5 (every leaf 6e-5 to 2e-4 off,
# none alone), so it has its own limits.
TOL = {"loss": 1e-5, "aux": 1e-5, "tokens": 0.0, "grad_norm": 2e-5,
       "lr": 0.0, "params": 1e-6, "m": 2e-5, "v": 2e-5}
# The MoE cases' last two rows are one token, so its row of the
# embedding's gradient sums 64 (jamba) or 2,080 (olmoe) terms that
# cancel, and two float32 summation orders part there by up to ~1e-4 of
# the largest |m|: the production step read 4.1e-6 (olmoe) and 3.5e-5
# (jamba) from one process (torch 2.13.0+cpu), and
# tests/test_torch_moe_layout.py holds it to repro's jitted step within
# the same limit.
# olmoe_ep's balance loss is repro's shard_map estimate, each data rank's
# over its own rows averaged over the data ranks, not the one process's
# over the whole batch.  On the CPU (torch 2.13.0+cpu), from this
# script's inputs and from repro's (tests/test_torch_moe_layout.py):
# aux 2.5e-2, 1.4e-2 from one process, and through its 0.01 weight loss
# 4.3e-5, 2.4e-5, grad_norm 4.2e-4, 1.2e-3, m 6.4e-4, 8.9e-4, v 1.9e-4,
# 4.5e-4 (params 9.4e-7, 1.7e-6).  Its limits hold these with room and
# lie far below a gradient that is one data rank's alone or counted once
# a model rank (m off by 0.5 or more); tests/test_torch_moe_layout.py
# holds the case to repro's own moe_ep step on a 2 x 2 mesh within the
# production layout's limits.
CASE_TOL = {"whisper": {"grad_norm": 2e-4, "m": 1e-3, "v": 5e-4},
            "olmoe": {"m": 2e-4}, "jamba": {"m": 2e-4},
            "olmoe_ep": {"loss": 2e-4, "aux": 0.1, "grad_norm": 5e-3,
                         "params": 1e-5, "m": 5e-3, "v": 2e-3}}


def tol(name: str) -> dict:
    return {**TOL, **CASE_TOL.get(name, {})}


# rank 0's matmul FLOPs / (the one-process step's / 4): a rank may not
# repeat another's product (each weight placed at its use,
# models/sharding.py::product_operands), nor do more than the step did
# when DTensor placed the products by the least redistribution (read
# under torch 2.13.0+cpu on a CPU host, and 2.11.0+cu128 on an H100's
# host; a case with no reading there is held to FLOPS_RATIO_MAX alone)
FLOPS_RATIO_MAX = 1.10
FLOPS_RATIO_BEFORE = {
    "2.13": {"deepseek": 1.2143, "deepseek_microbatches": 1.2143,
             "mamba2_factored_v": 1.0000, "internvl2": 1.2308,
             "whisper": 1.1162, "olmoe": 1.6067, "jamba": 1.0201},
    "2.11": {"deepseek": 1.071, "mamba2_factored_v": 1.149,
             "internvl2": 1.077, "whisper": 1.318, "olmoe": 1.595,
             "jamba": 1.126},
}


# olmoe_ep runs repro's shard_map body, whose in_specs leave x's rows
# whole over "model": every rank of a "model" group routes the same rows,
# each expert shard takes a pair once from each of them, and its buffers
# hold cap_e's 1.25 over-provision at capacity 8.0.  Rank 0 read 2.3844
# (torch 2.13.0+cpu); repro's program does the same work (the dry run's
# olmoe-1b-7b x train_4k x moe_ep reads 0.94 of repro's FLOPs a device)
CASE_FLOPS_MAX = {"olmoe_ep": 2.5}


def flops_limit(name: str, torch_version: str) -> float:
    """The most rank 0's ``flops_ratio`` may read for case ``name``."""
    before = FLOPS_RATIO_BEFORE.get(".".join(torch_version.split(".")[:2]),
                                    {})
    top = CASE_FLOPS_MAX.get(name, FLOPS_RATIO_MAX)
    return min(top, before.get(name, top))


def case_batch(cfg, seed: int = 0, seq: int = 32) -> dict:
    """4 rows of ``seq`` positions, masks keeping 30, 27, 5 and 0 of
    every 32; the vlm's patch rows N(0, 0.02²), the encdec's frames
    N(0, 1); with experts, the last two rows one token over and
    over (but with ``moe_ep``, whose case runs at a capacity where
    nothing drops)."""
    from repro_torch.models import api
    rng = np.random.default_rng(seed)
    t = api.token_len(cfg, seq)
    tok = rng.integers(16, cfg.vocab_size, (4, t)).astype(np.int32)
    if cfg.num_experts and not cfg.moe_ep:
        tok[2:] = tok[3, 0]
    keep = np.array([30, 27, 5, 0]) * seq // 32
    batch = {"tokens": tok, "targets": np.roll(tok, -1, 1),
             "loss_mask": (np.arange(t)[None] < keep[:, None])
             .astype(np.float32)}
    if cfg.family in ("vlm", "encdec"):
        scale = 0.02 if cfg.family == "vlm" else 1.0
        batch["frontend"] = (rng.normal(size=(
            4, cfg.num_frontend_tokens, cfg.d_model)) * scale
        ).astype(np.float32)
    return batch


def write_inputs(d: str, cfg, opt, seed: int = 0, seq: int = 32) -> None:
    """The seeded state (non-zero moments, step 3) and batch of a case."""
    import torch

    from repro_torch.ckpt import save
    from repro_torch.models.params import tree_flatten
    from repro_torch.train.steps import init_train_state
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(cfg, opt, gen)
    with torch.no_grad():
        for m in tree_flatten(state["opt"]["m"])[0]:
            m.normal_(0.0, 1e-3, generator=gen)
        for v in tree_flatten(state["opt"]["v"])[0]:
            v.normal_(0.0, 1e-3, generator=gen).abs_().add_(1e-6)
    state["step"].fill_(3)
    save(os.path.join(d, "in"), 3, state)
    np.savez(os.path.join(d, "batch.npz"), **case_batch(cfg, seed, seq))


class RoutingTape:
    """Every MoE call's router logits, expert choices and kept pairs,
    whole (a DTensor's ``full_tensor``), while it is entered."""

    def __enter__(self):
        from repro_torch.models import moe as M
        self.logits, self.idx, self.keep = [], [], []
        self._orig = (M._route, M.expert_slots)
        route, slots = self._orig

        def whole(x):
            x = x.detach()
            return (x.full_tensor() if hasattr(x, "full_tensor")
                    else x).numpy()

        def taped_route(logits, k):
            w, idx = route(logits, k)
            self.logits.append(whole(logits))
            self.idx.append(whole(idx))
            return w, idx

        def taped_slots(idx, e, cap):
            out = slots(idx, e, cap)
            self.keep.append(whole(out[1]))
            return out
        M._route, M.expert_slots = taped_route, taped_slots
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as M
        M._route, M.expert_slots = self._orig

    def same_routing(self, other) -> bool:
        return (len(self.idx) == len(other.idx) > 0 and all(
            np.array_equal(a, b) and a.dtype == b.dtype for a, b in
            zip(self.idx + self.keep, other.idx + other.keep)))


def rank_main(rank: int, out: str, names) -> int:
    import torch
    import torch.distributed as dist
    # one thread a rank: four ranks share the host's cores
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out, "pg"), rank=rank, world_size=WORLD)
    from torch.distributed.tensor import Shard

    from repro_torch.ckpt import restore, save
    from repro_torch.launch.dryrun import operand_layout
    from repro_torch.launch.opcost import OpCounter
    from repro_torch.models.params import tree_flatten
    from repro_torch.runtime.elastic import build_mesh
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import (make_train_step, train_state_axes,
                                         train_state_shapes)
    mesh = build_mesh(model_parallel=MESH[1], device="cpu")
    report = {"torch": torch.__version__, "cases": {}}
    ok = True
    for name, arch, micro, kw in (ALL_CASES[n] for n in names):
        d = os.path.join(out, name)
        cfg = case_config(name)
        opt = OptConfig(**OPT_KW, **kw)
        shapes = train_state_shapes(cfg, opt)
        z = np.load(os.path.join(d, "batch.npz"))
        batch = {k: z[k] for k in z.files}
        step = make_train_step(cfg, opt, micro, mesh=mesh)
        state = restore(os.path.join(d, "in"), shapes,
                        shardings=step.shardings)
        with OpCounter("cpu") as oc, RoutingTape() as tape:
            new, metrics = step(state, batch)
        save(os.path.join(d, "out"), 4, new)
        whole = restore(os.path.join(d, "in"), shapes, device="cpu")
        with OpCounter("cpu") as one, RoutingTape() as one_tape:
            ref, rm = make_train_step(cfg, opt, micro)(
                copy.deepcopy(whole), batch)
        err = {k: abs(float(metrics[k]) - float(rm[k]))
               / max(abs(float(rm[k])), 1e-30) for k in rm}
        for part, a, b in (("params", new["params"], ref["params"]),
                           ("m", new["opt"]["m"], ref["opt"]["m"]),
                           ("v", new["opt"]["v"], ref["opt"]["v"])):
            pairs = list(zip(tree_flatten(a)[0], tree_flatten(b)[0]))
            scale = max(float(y.abs().max()) for _, y in pairs)
            err[part] = max(float((x.full_tensor() - y).abs().max())
                            for x, y in pairs) / scale
        leaves = tree_flatten(new)[0]
        sharded = [sum(isinstance(x.placements[i], Shard) for x in leaves)
                   for i in range(2)]
        local = sum(x.to_local().numel() * x.to_local().element_size()
                    for x in leaves)
        dry = operand_layout((shapes,), (train_state_axes(cfg, opt),),
                             mesh, state=(cfg, opt))[1]
        seen = [None] * WORLD
        dist.all_gather_object(seen, [sharded, local, dry, oc.cost.flops])
        within = all(err[k] <= t for k, t in tol(name).items())
        spread = all(s[0][0] > 0 and s[0][1] > 0 and s[1] == s[2]
                     for s in seen)
        ratio = seen[0][3] / (one.cost.flops / WORLD)
        limit = flops_limit(name, torch.__version__)
        routed = {}
        if cfg.moe_ep:
            # the hops ran: moe_ep's all_to_alls over "model"
            routed = {"all_to_all": oc.cost.coll_counts.get("all-to-all",
                                                            0)}
            within = within and routed["all_to_all"] > 0
        elif cfg.num_experts:
            routed = {"routing_equal": tape.same_routing(one_tape),
                      "pairs": int(sum(k.size for k in tape.keep)),
                      "dropped": int(sum((~k).sum() for k in tape.keep))}
            within = within and routed["routing_equal"]
            if rank == 0:
                np.savez(os.path.join(d, "router.npz"), *tape.logits)
        ok = ok and within and spread and ratio <= limit
        report["cases"][name] = {**routed,
            "err": err, "within_tol": within,
            "sharded_data_model_by_rank": [s[0] for s in seen],
            "local_bytes_by_rank": [s[1] for s in seen],
            "dryrun_bytes_by_rank": [s[2] for s in seen],
            "flops_by_rank": [s[3] for s in seen],
            "flops_one_process": one.cost.flops,
            "flops_ratio": ratio, "flops_limit": limit}
        if rank == 0:
            np.savez(os.path.join(d, "metrics.npz"),
                     **{k: v.numpy() for k, v in metrics.items()})
    report["ok"] = ok
    if rank == 0:
        print(json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


def run(out: str, timeout: float = 600.0, names=None) -> dict:
    """Make the missing inputs of the cases ``names`` (default CASES),
    start the 4 ranks, wait for them (killing all at the first failure
    or at ``timeout``), and return rank 0's report with each rank's exit
    code under "exit_codes"."""
    import time

    from repro_torch.train.optimizer import OptConfig
    names = list(names or [c[0] for c in CASES])
    for name in names:
        kw = ALL_CASES[name][3]
        d = os.path.join(out, name)
        if not os.path.exists(os.path.join(d, "batch.npz")):
            os.makedirs(d, exist_ok=True)
            write_inputs(d, case_config(name), OptConfig(**OPT_KW, **kw),
                         seq=CASE_SEQ.get(name, 32))
    pg = os.path.join(out, "pg")
    if os.path.exists(pg):
        os.remove(pg)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--out", out, "--cases", ",".join(names)], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env, cwd=ROOT, text=True)
        for r in range(WORLD)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    codes = [p.returncode for p in procs]
    lines = [ln for ln in texts[0].splitlines() if ln.startswith("{")]
    if not lines:
        bad = next((i for i, c in enumerate(codes) if c), 0)
        raise RuntimeError(f"production layout 2 x 2: rank {bad} exited "
                           f"{codes[bad]}:\n{texts[bad][-4000:]}")
    report = json.loads(lines[-1])
    report["exit_codes"] = codes
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="inputs, outputs and the process group's file "
                         "store (default: a temporary directory)")
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES),
                    help="comma-separated case names, of "
                         + ", ".join(ALL_CASES))
    ap.add_argument("--rank", type=int, default=None,
                    help="(internal) run as this rank")
    args = ap.parse_args(argv)
    names = args.cases.split(",")
    unknown = [n for n in names if n not in ALL_CASES]
    if unknown:
        ap.error(f"unknown cases {unknown}")
    if args.rank is not None:
        return rank_main(args.rank, args.out, names)
    if args.out is None:
        with tempfile.TemporaryDirectory() as out:
            report = run(out, names=names)
    else:
        os.makedirs(args.out, exist_ok=True)
        report = run(args.out, names=names)
    print(json.dumps(report))
    return 0 if report["ok"] and not any(report["exit_codes"]) else 1


if __name__ == "__main__":
    sys.exit(main())
