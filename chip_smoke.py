"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device line (torch's name, nvidia-smi's name and power limit);
  2. build the five hand kernels from src/repro_torch/kernels/*/csrc
     (hash_probe, spatial_join, segment_reduce, segment_topk,
     flash_attention), one nvcc per source, all at once;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the feed, the read path and serving (seeded inputs) and time
     kernel, plain version and the one PyTorch call computing the same
     function (none for segment_topk; scaled_dot_product_attention for
     flash_attention): each call's time, and for kernels and library calls
     the device's time per launch over back-to-back launches, beside an
     empty kernel's (the launch floor); sorted_probe at the feed's,
     Q6's and Q5's shapes; radius_join at Q4 (k = 8 and k = 1), Q5/Q7
     (k = 3), clustered references, a radius covering the whole table and
     probes on the radius, each bit-equal, each call captured in a CUDA
     graph whose nodes must be at most 4 kernels and no memset or copy,
     and one profiled call's kernels and their device ms logged;
     segment_sum and segment_topk also at the read path's shapes (one
     eager unit, a merged unit, a batched scan, 2^22 rows), and one
     segment_topk call each at 2,048 and 2^20 rows, captured in a graph,
     must issue at most 1 and 2 kernels and no memset or copy; flash
     attention logs the body (wgmma, mma_sync, cuda_core) of every case,
     and at the serving shape must take the wgmma body, held and timed
     beside the mma_sync body it replaced; whisper-medium's three
     non-causal shapes (the encoder at S = T = 1,536, the cross-attention
     of a 448-token prompt, a decode step's at S = 1 over 4 slots; G = 1
     at D = 64) are held and timed too;
  4. the feed: a fused Q1 -> Q4 -> Q6 plan over 20 x 6,720 tweets at the
     paper's reference cardinalities (scale 1.0), through FeedManager;
     the launch counters of its three kernels must grow during this run,
     segment_topk's and flash_attention's must not;
  5. cross-check the first 2 frames against a ComputingRunner on the CPU
     (plain versions): every output column equal;
  6. a group_by("country") count/mean query over the store, against numpy;
  7. the read path: a Q1 feed of 100 x 6,720 tweets into a store spilling
     2,000-row segments, then benchmarks/fig_query.py's queries (pruned
     scan, eager / batched / merged group-by with agg.topk, a top-16 by
     country) each bit-equal to the CPU on the same snapshot, and queries
     during a throttled feed with repair, compaction and rolling reference
     updates, which must converge.  Every top-k must take the kernel;
     the aggregation dispatches by (op, row bucket) are printed, each
     bucket's count weighted by the kernel's device time at that size;
  8. LM serving: deepseek-coder-33b at full width cut to 4 of 62 layers,
     bf16 parameters from a seed, 12 requests of 256-1,536 prompt tokens
     and 32 new tokens each through ServingEngine on 4 slots; every
     prefill attention must take the flash kernel (layers launches per
     admission, which takes its first token from prefill's logits; no
     "plain_on_card" attention); one
     prefill, apply and decode step profiled, whose flash time must all
     be the wgmma body's; each layer's q, k, v of a 1,536-token prefill
     held kernel against plain version; prompts of 32, 40 and 200
     tokens teacher-forced on the CPU from the same weights, logits held
     to the card's;
  9. LM training: the LM data plane (UDF2 -> tokenize -> safe-only filter
     -> packer, 2 partitions, over phase 4's tables) feeds the Trainer
     with deepseek-coder-33b at full width, 4 of 62 layers, bf16
     parameters, float32 AdamW, remat "full", batches of 2 x 4,096
     tokens; the first batch's gradient must be finite and non-zero in
     every leaf, then 2 warm and 10 timed steps with finite losses and an
     exact step count, one step profiled; no hand kernel may launch and
     every attention must be the chunked plain version ("plain_on_card");
     one step of a 1-layer model on a packed row of 1,024 tokens is held
     to the same step on the CPU;
 10-12. serving three more families whole (full width and depth, seeded
     float32 parameters, after phase 9's state is freed) through
     ServingEngine: olmoe-1b-7b (moe, 16 layers, 64 experts, 8 a token;
     12 requests of 256-1,536 tokens, 32 new), mamba2-130m (ssm, 24
     layers; 12 requests of whole 256-token chunks; no kernel may
     launch) and internvl2-2b (vlm, 24 layers after a 256-row zero
     frontend; 4 requests, 16 new).  Flash launches must be attention
     layers x prefills, no attention on the plain version;
     each phase prints tokens/s, prefill and decode ms, a profiled
     prefill, apply and decode step, and a teacher-forced CPU cross-check
     (olmoe cut to 2 layers); olmoe the share of routed pairs dropped for
     capacity, its decode time against the expert casts' floor and the
     router's card-vs-CPU agreement; mamba2 that float32 recurrent decode
     continues the chunked prefill at the chunk of 256;
 13. serving whisper-medium (encdec) whole, after phase 12's state is
     freed: 24 encoder and 24 decoder layers, seeded float32 parameters,
     bf16 activations, 8 requests of 32-448 prompt tokens, 32 new, 4
     slots, each after the engine's zero frontend of 1,536 frames.  Flash
     launches must be 2 x (24 encoder + 24 self + 24 cross) per admission
     plus 24 (cross) per decode step, no attention on the plain version;
     tokens/s, prefill and decode ms, a profiled prefill, apply and decode
     step, and a teacher-forced CPU cross-check (2 + 2 layers) over
     seeded random frames.
 14. (run right after phase 7, before serving) the durable, elastic feed
     of the whole workload over phase 4's tables: (a) three plans of 20
     x 6,720 tweets, 2 partitions each: A = Q1 > Q2 > ... > Q7 fused, B =
     UDF1, C = UDF2 (both write safety_check_flag, so each is a plan of
     its own); launches must be exactly the path's (A: 2 probes and 3
     joins an invocation, one int64 sum per Q2 build, two counts per Q6
     build; Q3's top-3 over 50,000 countries is outside segment_topk's
     envelope and must run plain on the card, once per build; B and C
     launch nothing), the first 2 frames of each held to a CPU
     ComputingRunner in every column; records/s, per-stage seconds and a
     profiled batch's device busy share; (c) plan A scaled up by 2
     partitions mid-stream over (a)'s first 8 frames, bitwise equal by id
     to (a)'s rows, and a 3-partition feed scaled down by one under a
     backlog, each tweet stored exactly once; (b) 2 crash rounds: a child
     interpreter (this script, --durable-child) runs plan A durable (WAL,
     checkpoints, repair) on the card over 12 frames (cut from 20 for
     time) under rolling upserts to safety_levels and suspicious_names,
     is SIGKILLed at a seeded random point of its ingest window, and the
     feed is resumed on the card (FeedManager.resume) under more upserts,
     which then stop while repair converges: no row lost or doubled,
     every row's Q1 and Q5 columns current under the final tables (by
     numpy lookup for every row, and against a CPU Q1 > Q5 on the first
     2 frames); the replay backlog and the recovery seconds of each round.
 15. training the other families on the card, after phase 13's state is
     freed, with TF32 on as in phase 9: first Q5 over one batch, every
     column equal to the CPU's (its distances take no cuBLAS product);
     then olmoe-1b-7b (4 of 16 layers at full width), mamba2-130m and
     internvl2-2b whole and whisper-medium (12 + 12 of 24 + 24 layers),
     each through the Trainer fed by the LM data plane (2 x 4,096
     positions, internvl2's first 256 seeded patch rows; whisper 8 x 448
     tokens over 8 x 1,536 seeded frames):
     every loss and gradient norm finite, the exact step count, no
     kernel launched and every attention the plain chunked version;
     tokens/s, the step split, peak memory and train_mfu; one step of a
     cut model from a seeded state held to the CPU's (FAMILY_TRAIN_TOL,
     from scripts/family_train_spread.py);
 16. the distributed modules at world size 1: an NCCL group of one rank
     over a file store, a (1, 1) mesh, moe_ffn_ep against moe_ffn at
     olmoe's width (capacity 8.0), a 2-layer olmoe's loss with moe_ep on
     and off, one Trainer step with moe_ep on the mesh's production
     layout, its loss and gradient norm bit-equal to the plain
     Trainer's, psum_compressed against decompress(compress(g)), and a
     checkpoint of the mesh's state restored onto a new mesh's
     placements, bit-equal.
 17. the launch tooling (repro_torch.launch.dryrun, opcost, roofline,
     report) held to the card.  Three dry runs trace one after another,
     each in a child interpreter over its own fake process group with
     meta shards on the card's device type: phase 9's training cell and
     phase 8's dense prefill (one row of 1,536 tokens) at 1 x 1, and
     mamba2-130m x decode_32k at 256 ranks.
     (a) phase 9's step run for real (seeded state and tokens, TF32 on):
     the bytes of its state and batch equal the dry run's argument bytes
     and the FLOPs opcost counts on the card equal the dry run's, by
     operand type, exactly; the peak bytes (max_memory_allocated above
     what was allocated before the state) within LAUNCH_MEM_BAND of the
     dry run's argument + temporary + output bytes; the roofline seconds
     beside the measured step; (b) the prefill run for real: argument
     bytes equal, its flash launches equal the dry run's flash sites (one
     a layer), and its FLOPs the dry run's less the plain flash
     version's at each site; (c) the 256-rank cell's row through
     report.fmt_row, its useful_ratio within LAUNCH_USEFUL_BAND, and its
     collective wire bytes a device, with the heaviest collectives
     (top_wire), at most repro's (LAUNCH_WIRE_REPRO).
 18. the trainer's production layout (FSDP over "data", tensor
     parallelism over "model", every leaf of the state a DTensor), over
     an NCCL group of one rank and a (1, 1) mesh, TF32 on: (a) the
     Trainer on phase 9's model cut to 1 of 62 layers at full width,
     float32 AdamW, 2 x 4,096 tokens from the LM data plane, 3 steps
     with a checkpoint at step 2 and a failure injected before step 3;
     the state it restores is the saved one bit for bit, and its
     losses, gradient norms and token counts equal the plain Trainer's
     on the same seed and batches bit for bit; (b) phase 9's cell (4
     layers) on the production layout: the rank's argument bytes equal
     phase 17's dry run's, and the step's time and device busy share
     beside the plain step's (phase 17 (a)) and phase 9's: DTensor's
     host cost a plain op; (c) scripts/production_layout_2x2.py on the
     host's CPU (4 gloo ranks, the card machine's torch): the 2 x 2
     production step held to one process at the tests' limits, and rank
     0's matmul FLOPs to the one-process step's quarter (each weight
     placed at its use: at most 1.10, and no more than before), started
     before (a) and waited for before (b).  (a) and (b) print their step
     beside the one read before each weight was placed at its use.
 19. the MoE and hybrid families on the production layout (experts over
     "model" as DTensors, MoE routing under DTensor), over an NCCL group
     of one rank and a (1, 1) mesh, TF32 on: (a) olmoe-1b-7b at full
     width, phase 15's 4 of 16 layers, and (b) jamba-1.5-large-398b at
     smoke widths, each 3 Trainer steps of 2 x 4,096 tokens from the LM
     data plane beside the plain Trainer on the same seed and batches:
     losses, gradient norms, token counts and the routed pairs dropped
     for capacity bit-equal, the state's bytes equal
     launch/dryrun.py::operand_layout's, each run's step time and (a)'s
     device busy share; (c) scripts/production_layout_2x2.py --cases
     olmoe,jamba,olmoe_ep on the host's CPU (the card machine's torch),
     started before (a): routing equal to one process and some pairs
     dropped (olmoe_ep, moe_ep on the production layout: its hops run),
     every reading within the script's limits, rank 0's FLOPs as in
     18 (c).
Each path (4-6, 7, 14, 8, 9, 10, 11, 12, 13, 15's four, 16, 17, 18, 19)
runs with the launch counts set to 0 just before it and read just after;
the kernels line gives each kernel's launches on the paths (feed,
read_path, serve, train, feed_durable, serve_moe, serve_ssm, serve_vlm,
serve_encdec, train_moe, train_ssm, train_vlm, train_encdec,
train_distributed, launch, train_production, train_moe_production) and
their sum.
Prints one JSON line of kernels, then the device JSON as the last line.
Measurements also go to <--out>/chip_smoke.json (default smoke_out/).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.launch.mesh import H100  # noqa: E402  (the checkout's)

# H100 SXM published peaks (NVIDIA data sheet), from the port's one
# hardware model: memory, float32 and dense bf16 tensor-core rates
PEAK_BYTES_S = H100.hbm_bw
PEAK_F32_S = H100.peak_f32_flops
PEAK_BF16_S = H100.peak_flops

BATCH = 6720                 # fig25's 16X batch
FRAMES = 20
SEED_TABLES, SEED_STREAM = 7, 11
CHECK_FRAMES = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(statistics.median(times))


def device_ms(fn, n: int = 30) -> float:
    """Device time per launch in ms: ``n`` back-to-back launches of ``fn``
    between one event pair, divided by ``n``.  A sleep kernel ahead of them
    holds the stream until all ``n`` are queued, so the host's cost per
    call (in ``time_ms``'s single-call time) does not space them out.
    ``fn`` must not synchronise."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000          # ~10 ms at an H100's clock
    for _ in range(4):
        s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if host_ms < s0.elapsed_time(a):
            return a.elapsed_time(b) / n
        cycles *= 4
    raise AssertionError(f"{n} launches took {host_ms:.1f} ms to queue, "
                         "longer than the sleep ahead of them")


def bound(nbytes: float, nops: float, peak_ops: float = PEAK_F32_S):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / peak_ops * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def kernel_device_ms(prof, name_part: str = "") -> float:
    """Device time in ms of the kernels a torch.profiler run saw (only
    those whose name contains ``name_part``).  Only the kernel events
    count: an operator's self device time is its kernels' time again, so
    summing every event would count each kernel PyTorch launched twice
    (kernels launched through ctypes have no operator)."""
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and name_part in ev.key) / 1e3


def profiled(fn):
    """Run ``fn`` once under torch.profiler; (profile, wall ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall * 1e3


def profiled_seen(fn, tries: int = 3):
    """``profiled``, taken again (up to ``tries`` times in all) while the
    profile shows no device event at all: profiled kernel calls have come
    back empty on some runs, with no cause found."""
    for _ in range(tries):
        prof, wall_ms = profiled(fn)
        if any(ev.device_type == torch.autograd.DeviceType.CUDA
               for ev in prof.key_averages()):
            break
        log("profile showed no device event; profiling again")
    return prof, wall_ms


def device_events(fn) -> dict:
    """The device events of one profiled call of ``fn`` (profiled_seen):
    {name: {"count", "device_ms"}}, for the log (the launch checks read
    ``graph_ops``); {} if no profile showed one."""
    prof, _ = profiled_seen(fn)
    return {ev.key: {"count": ev.count,
                     "device_ms": ev.self_device_time_total / 1e3}
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


# CUgraphNodeType (cuda.h) by value
GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
                    "wait_event", "event_record", "ext_semas_signal",
                    "ext_semas_wait", "mem_alloc", "mem_free",
                    "batch_mem_op", "conditional")


def graph_ops(fn) -> dict:
    """The device operations one call of ``fn`` issues, by kind
    ({"kernel": n, "memset": m, ...}): the nodes of a CUDA graph captured
    around the call, read through the CUDA driver.  Exact, and needs no
    profiler; a call that synchronises with the host cannot be captured
    and raises here."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    raw = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    ops: dict = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        name = (GRAPH_NODE_TYPES[kind.value]
                if 0 <= kind.value < len(GRAPH_NODE_TYPES)
                else f"type {kind.value}")
        ops[name] = ops.get(name, 0) + 1
    return ops


def check_ops(what: str, ops: dict, most: int) -> None:
    """Fails unless ``ops`` (from graph_ops) is 1 to ``most`` kernels and
    no other operation (no memset, no copy)."""
    kernels = ops.get("kernel", 0)
    if not 0 < kernels <= most or set(ops) != {"kernel"}:
        raise AssertionError(f"{what} issued {ops} on the device, not 1 "
                             f"to {most} kernels and no memset or copy")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def launch_floor_ms() -> float:
    """Device ms per launch of an empty kernel (torch.cuda._sleep(0): one
    thread that returns at once), back-to-back: the least a launch costs
    on this card, beside which the short kernels are read."""
    return device_ms(lambda: torch.cuda._sleep(0), n=100)


# (tag, probes, key rows, real keys): the feed's and the read path's Q1
# probe of safety_levels (also Q6's district ids), Q6's income join and
# Q5's suspicious_names join (1,000,000 names, not on a path yet)
PROBE_CASES = [("feed", BATCH, 50_176, 50_000),
               ("q6_income", 512, 512, 500),
               ("q5_names", BATCH, 1_000_192, 1_000_000)]
PROBE_HEAD = "feed"


def check_sorted_probe(dev, rng):
    """Bit-equal to the plain version at PROBE_CASES, with sentinel,
    duplicate and below-all probes and a run of duplicate keys (leftmost
    match wins); timed beside torch.searchsorted."""
    from repro_torch.core.refdata import KEY_SENTINEL
    from repro_torch.kernels.hash_probe import kernel, ref
    rows = {}
    for tag, b, r, r_valid in PROBE_CASES:
        keys = np.full(r, KEY_SENTINEL, np.int64)
        keys[:r_valid] = np.sort(rng.choice(4 * r_valid, r_valid,
                                            replace=False))
        keys[10:14] = keys[10]                          # duplicate keys
        probe = rng.integers(0, 4 * r_valid, b).astype(np.int64)  # ~1/4 hit
        probe[:64] = KEY_SENTINEL                                # sentinels
        probe[64:128] = probe[128:192]                           # duplicates
        probe[192:256] = -5                                      # below all
        probe[256:260] = keys[10]
        p, k = t(probe, dev), t(keys, dev)
        gi, gf = kernel.sorted_probe(p, k)
        wi, wf = ref.sorted_probe(p, k)
        torch.cuda.synchronize()
        if not (torch.equal(gi, wi) and torch.equal(gf, wf)):
            raise AssertionError(f"sorted_probe[{tag}] kernel != plain")
        err = float((gi.long() - wi.long()).abs().max())
        ms = time_ms(lambda: kernel.sorted_probe(p, k))
        plain = time_ms(lambda: ref.sorted_probe(p, k))
        lib = time_ms(lambda: torch.searchsorted(k, p))
        dev_ms = device_ms(lambda: kernel.sorted_probe(p, k))
        lib_dev = device_ms(lambda: torch.searchsorted(k, p))
        # a lower-bound search reads at most ceil(log2 R) keys a probe
        steps = int(np.ceil(np.log2(r)))
        nbytes = b * 8 + min(r, b * steps) * 8 + b * (4 + 1)
        b_ms, b_by = bound(nbytes, b * steps)
        log(f"kernel sorted_probe[{tag}] B={b} R={r}: max_abs_err={err} "
            f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} library_device_ms={lib_dev:.4f} "
            f"(torch.searchsorted) bound_ms={b_ms:.6f} ({b_by}) "
            f"hits={int(gf.sum())}")
        rows[tag] = {"probes": b, "rows": r, "max_abs_err": err, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain,
                     "library_ms": lib, "library_device_ms": lib_dev,
                     "bound_ms": b_ms, "bound_by": b_by}
    floor = launch_floor_ms()
    log(f"launch floor: empty kernel device_ms={floor:.4f}")
    return {"name": "sorted_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/hash_probe/csrc/hash_probe.cu",
            "replaces": "src/repro/kernels/hash_probe/kernel.py:75",
            **rows[PROBE_HEAD],
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            "launch_floor_ms": floor, "by_case": rows}


def spatial_points(layout, rng, b, r, radius, lo=(-60, -180),
                   hi=(60, 180)):
    """Probe and reference coordinates (px, py, rx, ry) for the spatial
    join's cases, float32, drawn uniformly over the box [lo, hi] (by
    default the tweets' latitudes and longitudes), then by ``layout``:

    uniform    as drawn;
    clustered  half the reference points within 5 degrees of 8 centres,
               and half the probes 0.3 degrees from a reference point;
    boundary   half the reference points on cell edges (multiples of the
               cell side) or one ulp off them, then every probe at exactly
               the radius, or one ulp in or out, from a reference point
               along x or y;
    nonfinite  NaN and infinite coordinates among probes and references;
    huge       the box [-0.5, 0.5]^2 moved to 1e6, where float32's ulp
               (0.0625) exceeds a radius below it.

    tests/test_torch_cuda.py and tests/test_torch_spatial_hopper.py draw
    their cases here too."""
    f = np.float32
    if layout == "huge":
        lo, hi = (-0.5, -0.5), (0.5, 0.5)
    px = rng.uniform(lo[0], hi[0], b).astype(f)
    py = rng.uniform(lo[1], hi[1], b).astype(f)
    rx = rng.uniform(lo[0], hi[0], r).astype(f)
    ry = rng.uniform(lo[1], hi[1], r).astype(f)
    if layout == "clustered":
        h = r // 2
        c = rng.integers(0, 8, h)
        cx = rng.uniform(lo[0] + 10, hi[0] - 10, 8)[c]
        cy = rng.uniform(lo[1] + 10, hi[1] - 10, 8)[c]
        ang, rad = rng.uniform(0, 2 * np.pi, h), 5 * np.sqrt(rng.random(h))
        rx[:h] = (cx + rad * np.cos(ang)).astype(f)
        ry[:h] = (cy + rad * np.sin(ang)).astype(f)
        n = min(b // 2, r)
        px[:n], py[:n] = rx[:n] + f(0.3), ry[:n]
    elif layout == "boundary":
        from repro_torch.kernels.spatial_join.kernel import grid_plan
        cell = f(grid_plan(r, radius).radius_w)
        h = r // 2
        edge = rng.integers(int(np.ceil(lo[0] / cell)),
                            int(np.floor(hi[0] / cell)) + 1, h) * cell
        edge = edge.astype(f)
        rx[:h] = np.select([np.arange(h) % 3 == 0, np.arange(h) % 3 == 1],
                           [edge, np.nextafter(edge, f(np.inf))],
                           np.nextafter(edge, f(-np.inf)))
        rad = f(radius)
        offs = [rad, np.nextafter(rad, f(0)), np.nextafter(rad, f(np.inf)),
                -rad, -np.nextafter(rad, f(np.inf))]
        for i in range(b):
            j = i % r
            px[i], py[i] = rx[j], ry[j]
            if i % 2:
                px[i] = f(px[i] + offs[i % len(offs)])
            else:
                py[i] = f(py[i] - offs[i % len(offs)])
    elif layout == "nonfinite":
        px[:3], py[3:5] = [np.nan, np.inf, -np.inf], [np.nan, np.inf]
        rx[:4], ry[3:6] = [np.nan, np.inf, -np.inf, 1.0], \
            [np.nan, -np.inf, np.inf]
    elif layout == "huge":
        px, py, rx, ry = (a + f(1e6) for a in (px, py, rx, ry))
    return px, py, rx, ry


# (tag, probes, reference rows, valid rows, radius, k, layout): Q4's
# monuments (the feed's join, k = 8, and radius_count's k = 1), Q5/Q7's
# religious buildings (k = 3), the Q4 shape with clustered references, a
# radius covering the whole table, and probes on the radius boundary
SPATIAL_CASES = [("q4", BATCH, 50_176, 50_000, 1.5, 8, "uniform"),
                 ("q4_count", BATCH, 50_176, 50_000, 1.5, 1, "uniform"),
                 ("q5_q7", BATCH, 10_240, 10_000, 3.0, 3, "uniform"),
                 ("clustered", BATCH, 50_176, 50_000, 1.5, 8, "clustered"),
                 ("whole_table", BATCH, 50_176, 50_000, 400.0, 8,
                  "uniform"),
                 ("boundary", BATCH, 50_176, 50_000, 1.5, 8, "boundary")]
SPATIAL_HEAD = "q4"
# most device operations one radius_join call may issue, no memset
SPATIAL_MAX_LAUNCHES = 4


def check_radius_join(dev, rng):
    """Bit-equal to the plain version (idx, dist2, count) at
    SPATIAL_CASES; timed beside cdist + topk.  The bound counts the bytes
    these inputs need (probes, reference coordinates and flags in, k
    slots and a count out); the dense 5 * B * R float operations the TPU
    kernel did stay logged as dense_ops_ms.  Each case's call is
    captured in a CUDA graph (check_spatial_launches holds its nodes to
    at most SPATIAL_MAX_LAUNCHES kernels and no memset or copy), and one
    profiled call logs its device events and their device ms."""
    from repro_torch.kernels.spatial_join import kernel, ref
    f = np.float32
    rows = {}
    for tag, b, r, r_valid, radius, k, layout in SPATIAL_CASES:
        px, py, rx, ry = spatial_points(layout, rng, b, r, radius)
        if layout != "boundary":
            # a few probes on reference points and on the radius boundary
            px[:8], py[:8] = rx[:8], ry[:8]
            px[8:16], py[8:16] = rx[8:16] + f(radius), ry[8:16]
        valid = np.arange(r) < r_valid
        args = [t(a, dev) for a in (px, py, rx, ry)]
        vt = t(valid, dev)

        def run():
            return kernel.radius_join(*args, radius, k, vt)
        gi, gd, gc = run()
        wi, wd, wc = ref.radius_join(*args, radius, k, vt)
        torch.cuda.synchronize()
        same_d = torch.equal(gd.view(torch.int32), wd.view(torch.int32))
        if not (torch.equal(gi, wi) and torch.equal(gc, wc) and same_d):
            bad = int((gi != wi).sum()) + int((gc != wc).sum())
            raise AssertionError(f"radius_join[{tag}] kernel != plain "
                                 f"({bad} idx/count slots differ; dist2 "
                                 f"bits equal: {same_d})")
        fin = torch.isfinite(wd)
        err = float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0
        ms = time_ms(run)
        dev_ms = device_ms(run)
        plain = time_ms(lambda: ref.radius_join(*args, radius, k, vt),
                        reps=3, warm=1)
        p2 = torch.stack(args[:2], 1)
        r2 = torch.stack(args[2:], 1)[:r_valid]

        def lib_run():
            return torch.topk(torch.cdist(p2, r2), k, largest=False)
        lib = time_ms(lib_run, reps=3, warm=1)
        lib_dev = device_ms(lib_run, n=5)
        nbytes = b * 8 + r * 9 + b * k * 8 + b * 4
        b_ms, b_by = bound(nbytes, 0.0)
        dense_ms = 5.0 * b * r_valid / PEAK_F32_S * 1e3
        log(f"kernel radius_join[{tag}] B={b} R={r} k={k} r={radius}: "
            f"max_abs_err={err} ms={ms:.4f} device_ms={dev_ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} "
            f"library_device_ms={lib_dev:.4f} (cdist+topk) "
            f"bound_ms={b_ms:.6f} ({b_by}) dense_ops_ms={dense_ms:.6f} "
            f"in_radius={int(gc.sum())}")
        rows[tag] = {"probes": b, "rows": r, "k": k, "radius": radius,
                     "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain, "library_ms": lib,
                     "library_device_ms": lib_dev, "bound_ms": b_ms,
                     "bound_by": b_by, "dense_ops_ms": dense_ms,
                     "in_radius": int(gc.sum())}
        # the call's device operations (a captured graph's nodes), and
        # one profiled call's device events, each with its count and
        # device ms
        rows[tag]["graph_ops"] = graph_ops(run)
        events = device_events(run)
        log(f"radius_join [{tag}]: graph {rows[tag]['graph_ops']}; device "
            "events: " + (", ".join(
                f"{n.split('(')[0]} x{e['count']} {e['device_ms']:.4f} ms"
                for n, e in events.items()) or "none seen, not measured"))
        rows[tag]["device_events"] = events
    return {"name": "radius_join", "route": "cuda",
            "source": ("src/repro_torch/kernels/spatial_join/csrc/"
                       "spatial_join.cu"),
            "replaces": "src/repro/kernels/spatial_join/kernel.py:103",
            **rows[SPATIAL_HEAD],
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            "by_case": rows}


def check_spatial_launches(by_case) -> None:
    """Fails unless one radius_join call issued at most
    SPATIAL_MAX_LAUNCHES kernels and no memset or copy, in every case of
    check_radius_join's ``by_case``."""
    for tag, row in by_case.items():
        check_ops(f"radius_join[{tag}]", row["graph_ops"],
                  SPATIAL_MAX_LAUNCHES)


# (tag, rows, segments, real groups, dtype): the feed's Q6 count width
# (1,000,192 persons into 16,385 district x ethnicity segments, every
# dtype), the batched read path's sum/mean widths (2^20 rows into S = 256,
# with 256 and with 6 real groups) and one eager unit (2,048 rows, S = 128);
# "count" is the count mode (no values: one per row)
SUM_CASES = [("feed", 1_000_192, 16_385, 16_385, dt)
             for dt in ("int32", "int64", "float32", "float64")]
SUM_CASES += [("feed", 1_000_192, 16_385, 16_385, "count")]
SUM_CASES += [(f"batched g={g}", 1 << 20, 256, g, dt)
              for g in (256, 6) for dt in ("int64", "float64")]
SUM_CASES += [("eager", 2048, 128, 6, dt) for dt in ("int32", "count")]
SUM_HEAD = "feed int32"


def check_segment_sum(dev, rng):
    """The kernel (count mode through ``kernel.segment_count``) against
    its plain version at SUM_CASES, 2 % of rows dropped (segments -2, -1,
    S and S + 1); integers exact, floats within 1e-6 (float32) or 1e-12
    (float64) of each segment's sum of |v|: atomics add in another order.
    Timed beside ``index_add_`` into zeros on the same inputs."""
    from repro_torch.kernels.segment_reduce import kernel, ref
    rows = {}
    for where, r, s, groups, dt in SUM_CASES:
        seg = rng.integers(0, groups, r).astype(np.int32)
        drop = rng.random(r) < 0.02
        seg[drop] = rng.choice([-2, -1, s, s + 1], int(drop.sum()))
        st = t(seg, dev)
        keep = (seg >= 0) & (seg < s)
        count = dt == "count"
        ndt = np.dtype("int32" if count else dt)
        if count:
            v = np.ones(r, np.int32)
        elif np.issubdtype(ndt, np.integer):
            v = rng.integers(-1000, 1000, r).astype(ndt)
        else:
            v = rng.normal(size=r).astype(ndt)
        vt = t(v, dev)
        if count:
            def run():
                return kernel.segment_count(st, s)
        else:
            def run():
                return kernel.segment_sum(vt, st, s)
        got = run()
        want = ref.segment_sum(vt, st, s)
        torch.cuda.synchronize()
        tag = f"{where} {dt}"
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"segment_sum[{tag}] returned {got.dtype} "
                                 f"{tuple(got.shape)}")
        err = float((got - want).abs().max())
        if np.issubdtype(ndt, np.integer):
            if err != 0:
                raise AssertionError(f"segment_sum[{tag}] not exact")
        else:
            rel = 1e-6 if ndt == np.float32 else 1e-12
            scale = np.bincount(seg[keep], np.abs(v[keep]).astype(
                np.float64), s)
            diff = (got - want).abs().double().cpu().numpy()
            if not np.all(diff <= rel * scale + 1e-30):
                raise AssertionError(f"segment_sum[{tag}] beyond {rel} * "
                                     "sum|v|")
        ms = time_ms(run)
        plain = time_ms(lambda: ref.segment_sum(vt, st, s))
        lt = st.long().clamp(0, s - 1)
        lv = torch.where((st >= 0) & (st < s), vt, torch.zeros_like(vt))

        def library():
            torch.zeros(s, dtype=vt.dtype, device=dev).index_add_(0, lt, lv)
        lib = time_ms(library)
        dev_ms = device_ms(run)
        lib_dev = device_ms(library)
        isz = ndt.itemsize
        # count mode reads no values
        b_ms, b_by = bound(r * ((0 if count else isz) + 4) + s * isz,
                           float(r))
        log(f"kernel segment_sum[{tag}] R={r} S={s} groups={groups}: "
            f"max_abs_err={err:.3g} ms={ms:.4f} device_ms={dev_ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} "
            f"library_device_ms={lib_dev:.4f} (index_add_) "
            f"bound_ms={b_ms:.6f} ({b_by})")
        rows[tag] = {"rows": r, "segments": s, "groups": groups,
                     "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain, "library_ms": lib,
                     "library_device_ms": lib_dev, "bound_ms": b_ms,
                     "bound_by": b_by}
    return {"name": "segment_sum", "route": "cuda",
            "source": ("src/repro_torch/kernels/segment_reduce/csrc/"
                       "segment_reduce.cu"),
            "replaces": "src/repro/kernels/segment_reduce/kernel.py:71",
            **rows[SUM_HEAD],
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            "by_case": rows}


TOPK_ROWS = 1 << 20          # the bucket of a batched scan over phase 7
TOPK_HEAD = "ties S=256 k=16"  # phase 7(c)'s shape: group_by("country")
# (values, rows, S, real groups, k) at the read path's other shapes: one
# eager unit of group_by("safety_level") (6 groups of S = 128, top-3), one
# unit of phase 7(c), one merged unit, and 2^22 rows, more than the
# grid's shared memory holds at once
TOPK_SHAPES = [("ties", 2048, 128, 6, 3), ("ties", 2048, 256, 256, 16),
               ("ties", 32_768, 256, 256, 16),
               ("ties", 1 << 22, 256, 256, 16)]


def check_segment_topk(dev, rng):
    """Bit-equal to the plain version at R = 2^20 rows, S in {128, 256,
    2048}, k in {3, 16}, for dense ties (values -1..5) and few ties
    (values in [0, 2^31)), 5 % of rows dropped (seg = S); the
    group_by("safety_level") shape (6 real groups of S = 128); int64 values
    in [-2^40, 2^40), which rank clipped to [0, 2^31); and TOPK_SHAPES."""
    from repro_torch.kernels.segment_topk import kernel, ref
    draws = {"ties": lambda r: rng.integers(-1, 6, r).astype(np.int32),
             "wide": lambda r: rng.integers(0, 2**31, r).astype(np.int32),
             "int64": lambda r: rng.integers(-2**40, 2**40, r)}
    r = TOPK_ROWS
    cases = [(vn, r, s, s, k) for vn in ("ties", "wide")
             for s in (128, 256, 2048) for k in (3, 16)]
    cases += [("ties", r, 128, 6, k) for k in (3, 16)]
    cases += [("int64", r, 256, 256, k) for k in (3, 16)]
    cases += TOPK_SHAPES
    rows = {}
    for vname, r, s, groups, k in cases:
        vals = draws[vname](r)
        seg = rng.integers(0, groups, r).astype(np.int32)
        seg[rng.random(r) < 0.05] = s                      # dropped
        vt, st = t(vals, dev), t(seg, dev)
        got = kernel.segment_topk_idx(vt, st, s, k)
        want = ref.segment_topk_idx(vt, st, s, k)
        torch.cuda.synchronize()
        tag = f"{vname} S={s}" + (f" groups={groups}"
                                  if groups != s else "") + f" k={k}"
        if r != TOPK_ROWS:
            tag += f" R={r}"
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"segment_topk[{tag}]: {bad} slots differ "
                                 "from the plain version")
        err = float((got.long() - want.long()).abs().max())
        ms = time_ms(lambda: kernel.segment_topk_idx(vt, st, s, k))
        dev_ms = device_ms(lambda: kernel.segment_topk_idx(vt, st, s, k),
                           n=10)
        plain = time_ms(lambda: ref.segment_topk_idx(vt, st, s, k), reps=5)
        b_ms, b_by = bound(r * (vals.itemsize + 4) + s * k * 4, float(r))
        log(f"kernel segment_topk[{tag}] R={r}: max_abs_err={err} "
            f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain:.4f} "
            f"library_ms=null bound_ms={b_ms:.6f} ({b_by}) "
            f"filled={int((got >= 0).sum())}")
        rows[tag] = {"rows": r, "max_abs_err": err, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain,
                     "library_ms": None, "library_device_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by}
    # no single PyTorch call computes a per-segment top-k; the stable sort
    # of the composite key, the core of the plain version, for scale
    r = TOPK_ROWS
    comp = torch.randint(0, 2**40, (r,), device=dev)
    sort_ms = time_ms(lambda: torch.sort(comp, stable=True))
    sort_dev = device_ms(lambda: torch.sort(comp, stable=True), n=10)
    log(f"segment_topk scale: torch.sort(int64 composite, stable=True) "
        f"R={r}: {sort_ms:.4f} ms, device {sort_dev:.4f} ms")
    return {"name": "segment_topk", "route": "cuda",
            "source": ("src/repro_torch/kernels/segment_topk/csrc/"
                       "segment_topk.cu"),
            "replaces": "src/repro/kernels/segment_topk/kernel.py:108",
            **rows[TOPK_HEAD],
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            "stable_sort_ms": sort_ms, "stable_sort_device_ms": sort_dev,
            "by_case": rows}


# most device operations one segment_topk call may issue, by rows: one
# launch where the rows fit one block, two otherwise, and no memset
TOPK_LAUNCH_SHAPES = [(2048, 128, 3, 1), (TOPK_ROWS, 256, 16, 2)]


def check_topk_launches(dev, rng):
    """One segment_topk call per TOPK_LAUNCH_SHAPES captured in a CUDA
    graph: fails if it issued more kernels than allowed, or any memset or
    copy.  Returns each shape's operations, and a profiled call's device
    events by name."""
    from repro_torch.kernels.segment_topk import kernel
    out = {}
    for r, s, k, most in TOPK_LAUNCH_SHAPES:
        vt = t(rng.integers(-1, 6, r).astype(np.int32), dev)
        st = t(rng.integers(0, s, r).astype(np.int32), dev)

        def run():
            return kernel.segment_topk_idx(vt, st, s, k)
        run()
        torch.cuda.synchronize()
        ops = graph_ops(run)
        events = {n: e["count"] for n, e in device_events(run).items()}
        log(f"segment_topk launches R={r} S={s} k={k}: graph {ops} (at "
            f"most {most} kernels, no memset); device events "
            f"{events or 'none seen, not measured'}")
        out[f"R={r}"] = {"graph_ops": ops, "device_events": events}
        check_ops(f"segment_topk at R={r}", ops, most)
    return out


def weigh_buckets(dev, hist, rng):
    """The read path's aggregation dispatches on the card, from
    ``dispatch.bucket_stats()``: per (op, row bucket) its count and the
    kernel's device ms per launch at that many rows, at phase 3's head
    shapes (segment_sum: int64 into S = 256; segment_topk: top-16 of
    S = 256, values -1..5), and their product."""
    from repro_torch.kernels.segment_reduce import kernel as sr
    from repro_torch.kernels.segment_topk import kernel as st
    out, total = [], {}
    for (op, rows), count in sorted(hist.items()):
        if op not in ("segment_sum", "segment_topk"):
            continue
        seg = t(rng.integers(0, 256, rows).astype(np.int32), dev)
        if op == "segment_sum":
            v = t(rng.integers(-1000, 1000, rows), dev)

            def run():
                sr.segment_sum(v, seg, 256)
        else:
            v = t(rng.integers(-1, 6, rows).astype(np.int32), dev)

            def run():
                st.segment_topk_idx(v, seg, 256, 16)
        ms = device_ms(run, n=10)
        out.append({"op": op, "rows": rows, "launches": count,
                    "device_ms": ms, "device_ms_total": ms * count})
        total[op] = total.get(op, 0.0) + ms * count
        log(f"read: {op} at {rows} rows: {count} launches x {ms:.4f} ms "
            f"= {ms * count:.4f} ms on the device")
    log(f"read: aggregation kernels' device ms per read path, weighted by "
        f"the bucket histogram: {total}")
    return {"by_bucket": out, "total_ms": total}


# (B, S, T, H, Kv, D, causal, dtype): G = H / Kv in {1, 2, 4, 7}, D in
# {64, 112, 128} (bf16: 64 and 128 take the wgmma body, 112 mma_sync, 72
# the CUDA-core body), S off the 128-, 64- and 32-row tiles, causal S < T
# (top-left), non-causal S < T, one row and one key; phases 10 and 12's
# shapes: olmoe's G = 1 at D = 128 (its longest bucketed prompt), and
# internvl2's 256 frontend rows before a bucket of 16 and its longest
FLASH_CASES = [
    (1, 1536, 1536, 56, 8, 128, True, "bfloat16"),   # the serving prefill
    (1, 1552, 1552, 16, 16, 128, True, "bfloat16"),
    (1, 272, 272, 16, 8, 128, True, "bfloat16"),
    (1, 1792, 1792, 16, 8, 128, True, "bfloat16"),
    (2, 1000, 1000, 56, 8, 128, True, "bfloat16"),
    (1, 1, 1, 56, 8, 128, True, "bfloat16"),
    (2, 300, 300, 8, 8, 64, True, "bfloat16"),
    (1, 333, 333, 16, 4, 112, True, "bfloat16"),
    (1, 100, 300, 8, 2, 64, True, "bfloat16"),
    (1, 200, 520, 14, 2, 128, False, "bfloat16"),
    (1, 130, 130, 8, 2, 72, True, "bfloat16"),
    (2, 300, 300, 8, 8, 64, True, "float32"),
    (1, 333, 333, 16, 4, 112, True, "float32"),
    (1, 1000, 1000, 56, 8, 128, True, "float32"),
    (1, 100, 300, 8, 2, 64, True, "float32"),
    (1, 200, 520, 14, 2, 128, False, "float32"),
]
# |kernel - plain| <= tol * (1 + |plain|): bf16 output rounding (2^-9) and
# p rounded before (kernel) or after (plain) normalisation; float32
# summation order and the running max (test_kernels.py's tolerances)
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# timed: the serving path's prefill, and a longer causal prompt
FLASH_TIMED = [(1, 1536, 56, 8, 128), (1, 4096, 56, 8, 128)]
# whisper-medium's attentions (phase 13), all non-causal bf16 at G = 1,
# D = 64: (name, B, S, T, H, Kv, D)
FLASH_WHISPER = [("encoder", 1, 1536, 1536, 16, 16, 64),
                 ("cross", 1, 448, 1536, 16, 16, 64),
                 ("decode_cross", 4, 1, 1536, 16, 16, 64)]


def check_flash_whisper(dev, rng):
    """FLASH_WHISPER: the kernel against its plain version (FLASH_TOL),
    then the kernel, the plain version and scaled_dot_product_attention
    timed (call and device ms).  Non-causal, so the bound counts all 4 B
    H S T D products at the bf16 peak, or q, k, v and o moved once."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref
    rows = {}
    for name, b, s, t_, h, kv, d in FLASH_WHISPER:
        q = t(rng.normal(size=(b, s, h, d)).astype(np.float32), dev).to(
            torch.bfloat16)
        k = t(rng.normal(size=(b, t_, kv, d)).astype(np.float32), dev).to(
            torch.bfloat16)
        v = t(rng.normal(size=(b, t_, kv, d)).astype(np.float32), dev).to(
            torch.bfloat16)
        body = kernel.body(q.dtype, d)
        got = kernel.flash_attention(q, k, v, False)
        want = ref.flash_attention(q, k, v, False).float()
        diff = (got.float() - want).abs()
        e = float(diff.max())
        if body != "wgmma" or not bool(torch.isfinite(got.float()).all()) \
                or bool((diff > FLASH_TOL["bfloat16"]
                         * (1 + want.abs())).any()):
            raise AssertionError(
                f"flash_attention whisper {name} (B={b} S={s} T={t_} H={h} "
                f"Kv={kv} D={d} non-causal): body {body}, max |kernel - "
                f"plain| {e} beyond {FLASH_TOL['bfloat16']} * (1 + |plain|)")
        del want, diff
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def call():
            kernel.flash_attention(q, k, v, False)

        def library():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=False,
                                           enable_gqa=True)
        ms, lib = time_ms(call), time_ms(library)
        dev_ms, lib_dev = device_ms(call), device_ms(library)
        plain = time_ms(lambda: ref.flash_attention(q, k, v, False), reps=5)
        flops = 4.0 * b * h * s * t_ * d
        nbytes = 2 * (2 * b * s * h * d + 2 * b * t_ * kv * d)
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_S)
        log(f"kernel flash_attention whisper {name}[B={b} S={s} T={t_} "
            f"H={h} Kv={kv} D={d} non-causal bf16]: body={body} "
            f"max_abs_err={e:.3g} (tol {FLASH_TOL['bfloat16']}) "
            f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} library_device_ms={lib_dev:.4f} "
            f"(scaled_dot_product_attention) bound_ms={b_ms:.6f} ({b_by}) "
            f"achieved={flops / dev_ms / 1e9:.1f} TFLOP/s on the device")
        rows[f"whisper {name}"] = {
            "shape": [b, s, t_, h, kv, d], "causal": False, "body": body,
            "max_abs_err": e, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain, "library_ms": lib,
            "library_device_ms": lib_dev, "bound_ms": b_ms,
            "bound_by": b_by}
    return rows


def check_flash_attention(dev, rng):
    """The kernel against its plain version on the card in every case of
    FLASH_CASES (logging the body each takes), then timed at FLASH_TIMED,
    causal bf16: the wgmma body, the mma_sync body it replaced at these
    shapes, the plain version and PyTorch's scaled_dot_product_attention,
    each call's time and (kernels, library) the device's per launch."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref
    err = 0.0
    for b, s, t_, h, kv, d, causal, dt in FLASH_CASES:
        tdt = getattr(torch, dt)
        q = t(rng.normal(size=(b, s, h, d)).astype(np.float32), dev).to(tdt)
        k = t(rng.normal(size=(b, t_, kv, d)).astype(np.float32), dev).to(tdt)
        v = t(rng.normal(size=(b, t_, kv, d)).astype(np.float32), dev).to(tdt)
        got = kernel.flash_attention(q, k, v, causal)
        want = ref.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        if got.dtype != q.dtype or got.shape != q.shape:
            raise AssertionError(f"flash_attention returned {got.dtype} "
                                 f"{tuple(got.shape)}")
        diff = (got.float() - want.float()).abs()
        e = float(diff.max())
        lim = FLASH_TOL[dt] * (1 + want.float().abs())
        if not bool(torch.isfinite(got.float()).all()) or \
                bool((diff > lim).any()):
            raise AssertionError(
                f"flash_attention B={b} S={s} T={t_} H={h} Kv={kv} D={d} "
                f"causal={causal} {dt}: max |kernel - plain| {e} beyond "
                f"{FLASH_TOL[dt]} * (1 + |plain|)")
        err = max(err, e)
        log(f"kernel flash_attention[B={b} S={s} T={t_} H={h} Kv={kv} "
            f"D={d} causal={causal} {dt}]: body={kernel.body(tdt, d)} "
            f"max_abs_err={e:.3g} (tol {FLASH_TOL[dt]})")
    rows = {}
    for b, s, h, kv, d in FLASH_TIMED:
        q = t(rng.normal(size=(b, s, h, d)).astype(np.float32), dev).to(
            torch.bfloat16)
        k = t(rng.normal(size=(b, s, kv, d)).astype(np.float32), dev).to(
            torch.bfloat16)
        v = t(rng.normal(size=(b, s, kv, d)).astype(np.float32), dev).to(
            torch.bfloat16)
        body = kernel.body(q.dtype, d)
        if body != "wgmma":
            raise AssertionError(f"flash_attention at bf16 D={d} takes the "
                                 f"{body} body, not wgmma")
        old = torch.empty_like(q)

        def wgmma():
            kernel.flash_attention(q, k, v, True)

        def mma_sync():
            # the body the wgmma body replaced at this shape: the library's
            # other entry point, which runs mma_sync for any bf16 D that
            # is a multiple of 16
            kernel.KERNEL.launch("flash_attention", dev, q.data_ptr(),
                                 k.data_ptr(), v.data_ptr(), old.data_ptr(),
                                 b, s, s, h, kv, d, 1, d ** -0.5,
                                 kernel.DTYPES[q.dtype])
        want = ref.flash_attention(q, k, v, True).float()
        mma_sync()
        for name, got in (("wgmma", kernel.flash_attention(q, k, v, True)),
                          ("mma_sync", old)):
            diff = (got.float() - want).abs()
            if bool((diff > FLASH_TOL["bfloat16"] * (1 + want.abs())).any()):
                raise AssertionError(
                    f"flash_attention's {name} body at S=T={s}: max |kernel "
                    f"- plain| {float(diff.max())} beyond "
                    f"{FLASH_TOL['bfloat16']} * (1 + |plain|)")
        del want
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def library():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        ms, old_ms, lib = time_ms(wgmma), time_ms(mma_sync), time_ms(library)
        dev_ms, old_dev, lib_dev = (device_ms(wgmma), device_ms(mma_sync),
                                    device_ms(library))
        plain = time_ms(lambda: ref.flash_attention(q, k, v, True), reps=5)
        # causal: half of the 4 B H S T D products; q, k, v, o once each
        flops = 2.0 * b * h * s * s * d
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d)
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_S)
        log(f"kernel flash_attention[B={b} S=T={s} H={h} Kv={kv} D={d} "
            f"causal bf16]: body={body} ms={ms:.4f} device_ms={dev_ms:.4f} "
            f"(mma_sync body: ms={old_ms:.4f} device_ms={old_dev:.4f}) "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} "
            f"library_device_ms={lib_dev:.4f} "
            f"(scaled_dot_product_attention) bound_ms={b_ms:.6f} ({b_by}) "
            f"achieved={flops / dev_ms / 1e9:.1f} TFLOP/s on the device, "
            f"{flops / ms / 1e9:.1f} per call")
        rows[f"S={s}"] = {"body": body, "ms": ms, "device_ms": dev_ms,
                          "mma_sync_ms": old_ms, "mma_sync_device_ms": old_dev,
                          "plain_ms": plain, "library_ms": lib,
                          "library_device_ms": lib_dev, "bound_ms": b_ms,
                          "bound_by": b_by}
    whisper = check_flash_whisper(dev, rng)
    err = max([err] + [r["max_abs_err"] for r in whisper.values()])
    rows.update(whisper)
    return {"name": "flash_attention", "route": "cuda",
            "source": ("src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention/kernel.py:121",
            "max_abs_err": err, **rows["S=1536"], "by_shape": rows}


# ---------------------------------------------------------------------------
# phases 4-6: the feed, the CPU cross-check, the query
# ---------------------------------------------------------------------------

def layer_breakdown(dev, store, nbatch=4):
    """The fused plan's layers per batch on ONE thread (no intake thread,
    no second worker): a ComputingRunner on the card over ``nbatch``
    pre-drawn frames, first use excluded.  The run alternates
    point_in_rect's tile on the card between 8192 (the CPU tile) and
    ``ops.RECT_CHUNK_CUDA`` (A, B, B, A, A, B).  A last pass runs under
    torch.profiler for the device's busy share of the wall."""
    from repro_torch.core import ComputingRunner, ComputingSpec, \
        SyntheticAdapter
    from repro_torch.core.computing import ComputingStats
    from repro_torch.core.enrich import ops
    from repro_torch.core.enrich import queries as Q
    frames = list(SyntheticAdapter(total=nbatch * BATCH, frame_size=BATCH,
                                   seed=SEED_STREAM).frames())
    fields = ("parse_s", "upload_s", "convert_s", "state_s", "apply_s")
    big = ops.RECT_CHUNK_CUDA
    out = {}
    spec = ComputingSpec(Q.Q1.then(Q.Q4).then(Q.Q6), BATCH)
    for tile in (8192, big, big, 8192, 8192, big):
        ops.RECT_CHUNK_CUDA = tile
        runner = ComputingRunner(spec, store, device=dev)
        runner.run(frames[0])                 # first use: not timed
        runner.stats = ComputingStats()
        t0 = time.perf_counter()
        for f in frames:
            runner.run(f)
        wall = time.perf_counter() - t0
        per = {k: getattr(runner.stats, k) / nbatch * 1e3 for k in fields}
        per["batch_ms"] = wall / nbatch * 1e3
        out.setdefault(tile, []).append(per)
        log(f"layers (1 thread, point_in_rect tile {tile}): ms per batch "
            + " ".join(f"{k}={v:.2f}" for k, v in per.items()))
    ops.RECT_CHUNK_CUDA = big
    runner = ComputingRunner(spec, store, device=dev)
    runner.run(frames[0])
    prof, wall_ms = profiled(lambda: [runner.run(f) for f in frames])
    dev_ms = kernel_device_ms(prof)
    busy = dev_ms / wall_ms
    log(f"layers (1 thread, profiled): device busy {dev_ms:.2f} ms "
        f"of {wall_ms:.2f} ms wall = {busy:.4f}")
    return {"by_tile": {str(k): v for k, v in out.items()},
            "profiled_wall_ms": wall_ms, "device_busy_ms": dev_ms,
            "device_busy_share": busy}


def run_feed(dev, store, frames=FRAMES):
    """The fused Q1 -> Q4 -> Q6 feed into the column store."""
    from repro_torch.core import FeedManager, SyntheticAdapter, pipeline
    from repro_torch.core.enrich import queries as Q
    total = frames * BATCH
    mgr = FeedManager(store, device=dev)
    t0 = time.perf_counter()
    feed = mgr.submit(
        pipeline(SyntheticAdapter(total=total, frame_size=BATCH,
                                  seed=SEED_STREAM), "chip_smoke")
        .parse(batch_size=BATCH).options(num_partitions=2)
        .enrich(Q.Q1.then(Q.Q4).then(Q.Q6)).store())
    stats = feed.join(timeout=900)
    wall = time.perf_counter() - t0
    if stats.stored != total:
        raise AssertionError(f"stored {stats.stored} of {total}")
    c = stats.computing
    inv, builds = c.invocations, c.state_builds
    log(f"feed: {total} tweets in {wall:.3f} s = {total / wall:,.0f} "
        f"records/s (smoke, one run, not a benchmark); "
        f"records_per_s(FeedStats)={stats.records_per_s:,.0f}")
    log(f"feed: invocations={inv} state_builds={builds} "
        f"parse_s={c.parse_s:.3f} upload_s={c.upload_s:.3f} "
        f"convert_s={c.convert_s:.3f} state_s={c.state_s:.3f} "
        f"apply_s={c.apply_s:.3f} predeploy={stats.predeploy}")
    split = {"wall_s": wall, "records_per_s": total / wall,
             "invocations": inv, "state_builds": builds,
             "parse_s": c.parse_s, "upload_s": c.upload_s,
             "convert_s": c.convert_s, "state_s": c.state_s,
             "apply_s": c.apply_s, "predeploy": stats.predeploy}
    return feed, split


def stored_rows(feed):
    from repro_torch.core.records import TWEET_SCHEMA
    cols = list(TWEET_SCHEMA) + ["safety_level", "nearby_monuments",
                                 "nearby_monument_count", "district",
                                 "area_avg_income", "area_facility_counts",
                                 "area_ethnicity_dist"]
    res = feed.query().select(*cols).execute()
    order = np.argsort(res["id"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in res.items()}


def cross_check(store, rows):
    from repro_torch.core import (ComputingRunner, ComputingSpec,
                                  SyntheticAdapter)
    from repro_torch.core.enrich import queries as Q
    # refresh="version": the tables are quiet, so the CPU builds Q6's
    # state once (the same pure function of the same ref versions)
    runner = ComputingRunner(ComputingSpec(Q.Q1.then(Q.Q4).then(Q.Q6),
                                           BATCH, refresh="version"),
                             store, device="cpu")
    ad = SyntheticAdapter(total=CHECK_FRAMES * BATCH, frame_size=BATCH,
                          seed=SEED_STREAM)
    t0 = time.perf_counter()
    outs = [runner.run(frame) for frame in ad.frames()]
    cpu_s = time.perf_counter() - t0
    cpu = {k: np.concatenate([o[k][o["valid"]] for o in outs])
           for k in rows}
    order = np.argsort(cpu["id"], kind="stable")
    cpu = {k: v[order] for k, v in cpu.items()}
    at = np.searchsorted(rows["id"], cpu["id"])
    if not np.array_equal(rows["id"][at], cpu["id"]):
        raise AssertionError("cross-check: CPU ids missing from the store")
    for k in rows:
        a, b = rows[k][at], cpu[k]
        if a.dtype != b.dtype or not np.array_equal(a, b):
            bad = int((a != b).reshape(len(a), -1).any(1).sum()) \
                if a.shape == b.shape else -1
            raise AssertionError(f"cross-check: column {k} differs "
                                 f"({a.dtype} vs {b.dtype}, {bad} rows)")
    log(f"cross-check: {len(cpu['id'])} rows of {CHECK_FRAMES} frames "
        f"equal on card and CPU in {len(rows)} columns "
        f"(CPU run {cpu_s:.1f} s); nearby_monuments found "
        f"{int((cpu['nearby_monuments'] >= 0).sum())}, districts found "
        f"{int((cpu['district'] >= 0).sum())}")
    return len(cpu["id"])


def check_query(feed, rows):
    from repro_torch.core.query import agg
    t0 = time.perf_counter()
    res = (feed.query().group_by("country")
           .agg(n=agg.count(), inc=agg.mean("area_avg_income")).execute())
    q_s = time.perf_counter() - t0
    keys, inv = np.unique(rows["country"].astype(np.int64),
                          return_inverse=True)
    n = np.bincount(inv, minlength=len(keys))
    s = np.bincount(inv, rows["area_avg_income"].astype(np.float64),
                    minlength=len(keys))
    if not (np.array_equal(res["country"], keys)
            and np.array_equal(res["n"], n)):
        raise AssertionError("query: group keys or counts differ")
    np.testing.assert_allclose(res["inc"], s / n, rtol=1e-9)
    st = res.stats
    log(f"query: {len(keys)} groups over {int(n.sum())} rows in "
        f"{q_s:.3f} s; kernel dispatches {st.agg_kernel_dispatches}, "
        f"other {st.agg_fallback_dispatches}")
    return q_s, st


# ---------------------------------------------------------------------------
# phase 7: the read path (fig_query's queries) at full size
# ---------------------------------------------------------------------------

READ_FRAMES = 100            # 672,000 tweets: 336 segments of 2,000 rows
LIVE_FRAMES = 20
SEGMENT_ROWS = 2000


def q1_store_plan(adapter, name, spill_dir, batch=BATCH,
                  segment_rows=SEGMENT_ROWS, refresh=None, compact=None):
    """benchmarks/fig_query.py's q1_store_plan: Q1 into a spilling store."""
    from repro_torch.core import pipeline
    from repro_torch.core.enrich import queries as Q
    return (pipeline(adapter, name).parse(batch_size=batch)
            .options(num_partitions=2, coalesce_rows=0, holder_capacity=16)
            .enrich(Q.Q1)
            .store(spill_dir=spill_dir, segment_rows=segment_rows,
                   refresh=refresh, compact=compact, upsert=True))


def safety_values(rng, n):
    return {"safety_level": rng.integers(0, 5, n).astype(np.int32)}


class RollingUpdater(threading.Thread):
    """Upserts ``nkeys`` random keys of ``keys`` (existing keys of
    ``table``) every ``every_s`` until stopped (benchmarks/fig_repair.py's
    workload), the columns drawn by ``values(rng, n)`` (default a safety
    level in [0, 5))."""

    def __init__(self, table, keys, every_s, nkeys, seed=5,
                 values=safety_values):
        super().__init__(name="rolling-updater", daemon=True)
        self.table = table
        self.keys = np.asarray(keys, np.int64)
        self.every_s, self.nkeys, self.values = every_s, nkeys, values
        self.rng = np.random.default_rng(seed)
        self.updates = 0
        self._stop_evt = threading.Event()

    def run(self):
        while not self._stop_evt.wait(self.every_s):
            keys = self.rng.choice(self.keys, self.nkeys, replace=False)
            self.table.upsert(keys, **self.values(self.rng, self.nkeys))
            self.updates += 1

    def stop(self):
        self._stop_evt.set()


def assert_same(a, b, what):
    if set(a) != set(b):
        raise AssertionError(f"{what}: columns {sorted(a)} != {sorted(b)}")
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or x.shape != y.shape or \
                not np.array_equal(x, y):
            raise AssertionError(f"{what}: column {k} differs ({x.dtype}"
                                 f"{x.shape} vs {y.dtype}{y.shape})")


def on_card(storage):
    return torch.device(storage.device).type == "cuda"


class ReadPath:
    """Runs each query on the store's device and, on the same snapshot,
    on the CPU (plain versions), and holds the two bit for bit.  Keeps
    the card runs' walls."""

    def __init__(self, storage):
        self.storage = storage
        self.walls = {}

    def run(self, name, q, snap, **kw):
        res = q.execute(snapshot=snap, **kw)
        if on_card(self.storage) and res.stats.agg_fallback_dispatches:
            raise AssertionError(f"{name}: {res.stats.agg_fallback_dispatches}"
                                 " aggregate dispatches took a plain version "
                                 "on the store's device")
        dev = self.storage.device
        self.storage.device = torch.device("cpu")
        try:
            cpu = q.execute(snapshot=snap, **kw)
        finally:
            self.storage.device = dev
        assert_same(res, cpu, f"{name} (device vs CPU)")
        self.walls[name] = {"device_s": res.stats.wall_s,
                            "cpu_s": cpu.stats.wall_s,
                            "units": res.stats.units,
                            "segments_pruned": res.stats.segments_pruned,
                            "rows_matched": res.stats.rows_matched,
                            "agg_invocations": res.stats.agg_invocations}
        log(f"read: {name}: device {res.stats.wall_s * 1e3:.1f} ms, CPU "
            f"{cpu.stats.wall_s * 1e3:.1f} ms; units {res.stats.units} "
            f"(pruned {res.stats.segments_pruned}), rows matched "
            f"{res.stats.rows_matched}, dispatches "
            f"{res.stats.agg_invocations} (kernel "
            f"{res.stats.agg_kernel_dispatches})")
        return res


    def profile(self, name, q, snap, **kw):
        """One more run of ``q`` under torch.profiler: the device's busy
        time against the query's wall."""
        prof, wall_ms = profiled(lambda: q.execute(snapshot=snap, **kw))
        dev_ms = kernel_device_ms(prof)
        busy = dev_ms / wall_ms
        self.walls[name]["profiled_wall_ms"] = wall_ms
        self.walls[name]["device_busy_ms"] = dev_ms
        self.walls[name]["device_busy_share"] = busy
        log(f"read: {name} profiled: device busy {dev_ms:.3f} ms of "
            f"{wall_ms:.1f} ms wall = {busy:.4f}")


def scan_topk(snap, key, value, payload, k):
    """numpy oracle of group_by(key).agg(topk(value, k, payload)): the
    live rows of the snapshot's units in scan order (fig_query.py's
    naive_check), ranked by clipped value desc, then scan order."""
    parts = {c: [] for c in (key, value, payload)}
    for ps in snap.parts:
        for u in ps.units:
            if u.rows == 0:
                continue
            cols = u.read((key, value, payload, "id"))
            live = ps.live_mask(cols["id"], u.base)
            for c in parts:
                parts[c].append(np.asarray(cols[c])[live])
    kv, v, p = (np.concatenate(parts[c]) for c in (key, value, payload))
    n = kv.shape[0]
    order = np.lexsort((np.arange(n), -np.clip(v.astype(np.int64), 0, None),
                        kv.astype(np.int64)))
    sk = kv[order].astype(np.int64)
    keys, starts = np.unique(sk, return_index=True)
    rank = np.arange(n) - np.repeat(starts, np.diff(np.append(starts, n)))
    keep = rank < k
    top = np.full((keys.shape[0], k), -1, p.dtype)
    top[np.searchsorted(keys, sk[keep]), rank[keep]] = p[order][keep]
    return keys, top


def read_path(dev, store, out_dir, frames=READ_FRAMES,
              live_frames=LIVE_FRAMES, batch=BATCH,
              segment_rows=SEGMENT_ROWS):
    """fig_query's read path through the port's entry points: a Q1 feed
    fills a spilling store, then (a) the pruned scan, (b) the merged read
    eager / batched / after merge_now, (c) a top-16 by country against a
    numpy scan, each bit-equal to the CPU on the same snapshot; (d)
    queries during a throttled feed with repair, compaction and rolling
    reference updates, then convergence.  Returns its measurements."""
    import shutil
    from repro_torch.core import (CompactionJob, CompactionSpec,
                                  FeedManager, RepairSpec, StoreSnapshot,
                                  SyntheticAdapter, agg, col)
    spill = os.path.join(out_dir, "read_path")
    shutil.rmtree(spill, ignore_errors=True)
    mgr = FeedManager(store, device=dev)
    total = frames * batch
    t0 = time.perf_counter()
    h = mgr.submit(q1_store_plan(
        SyntheticAdapter(total=total, frame_size=batch, seed=19),
        "read-fill", os.path.join(spill, "fill"), batch, segment_rows))
    st = h.join(timeout=900)
    if st.stored != total:
        raise AssertionError(f"read fill stored {st.stored} of {total}")
    h.storage.flush()
    fill_s = time.perf_counter() - t0
    segs = h.storage.segment_count
    log(f"read: Q1 feed filled {total} rows in {fill_s:.1f} s "
        f"({total / fill_s:,.0f} records/s), {segs} segments of "
        f"{segment_rows} rows")
    rp = ReadPath(h.storage)

    # (a) fig_query.py:118-131: selective id range, pruning on and off
    qa = (h.query().where(col("id") < total // 50)
          .group_by("safety_level")
          .agg(n=agg.count(), top=agg.topk("safety_level", 3)))
    with StoreSnapshot(h.storage) as snap:
        on = rp.run("a pruned", qa, snap, prune=True)
        off = rp.run("a unpruned", qa, snap, prune=False)
    assert_same(on, off, "(a) pruned vs unpruned")
    if on.stats.segments_pruned == 0 or off.stats.segments_pruned:
        raise AssertionError("(a) pruning did not prune")

    # (b) fig_query.py:269-313: eager, batched, then merged
    qb = (h.query().where(col("safety_level") >= 3)
          .group_by("safety_level")
          .agg(n=agg.count(), s=agg.sum("created_at"),
               top=agg.topk("safety_level", 2, payload="id")))
    with StoreSnapshot(h.storage) as snap:
        eager = rp.run("b eager", qb, snap, batched=False)
        bat = rp.run("b batched", qb, snap, batched=True)
        if on_card(h.storage):
            rp.profile("b batched", qb, snap, batched=True)
    t0 = time.perf_counter()
    job = CompactionJob(h.storage, CompactionSpec(
        budget_rows_s=1e6, merge_fanin=8,
        level_target_rows=8 * segment_rows))
    job.merge_now(min_run=2)
    merge_s = time.perf_counter() - t0
    merged_segs = h.storage.segment_count
    if merged_segs >= segs:
        raise AssertionError("merge_now merged nothing")
    log(f"read: merge_now {segs} -> {merged_segs} segments in "
        f"{merge_s:.1f} s (levels {h.storage.level_histogram()})")
    with StoreSnapshot(h.storage) as snap:
        merged = rp.run("b merged", qb, snap, batched=True)
    assert_same(eager, bat, "(b) eager vs batched")
    assert_same(eager, merged, "(b) eager vs merged")

    # (c) top-16 by country, at the envelope's k, against a numpy scan
    qc = (h.query().group_by("country")
          .agg(top=agg.topk("safety_level", 16, payload="id")))
    with StoreSnapshot(h.storage) as snap:
        rc = rp.run("c top16 by country", qc, snap)
        if on_card(h.storage):
            rp.profile("c top16 by country", qc, snap)
        keys, top = scan_topk(snap, "country", "safety_level", "id", 16)
    assert_same(rc, {"country": keys, "top": top}, "(c) vs numpy scan")
    log(f"read: (c) {keys.shape[0]} groups equal the numpy scan")

    # (d) fig_query.py:151-202: queries while a throttled feed ingests,
    # repair re-enriches under rolling updates and compaction reclaims
    table = store["safety_levels"]
    nbase = len(table)
    upd = RollingUpdater(table, np.arange(nbase), 0.1, min(25, nbase))
    live_total = live_frames * batch
    h2 = mgr.submit(q1_store_plan(
        SyntheticAdapter(total=live_total, frame_size=batch, seed=13,
                         rate=20_000.0),
        "read-live", os.path.join(spill, "live"), batch, segment_rows,
        refresh=RepairSpec(budget_rows_s=20_000.0),
        compact=CompactionSpec(budget_rows_s=100_000.0,
                               min_dead_frac=0.2, interval_s=0.1)))
    upd.start()
    qd = (h2.query().where(col("id") < live_total // 50)
          .group_by("safety_level")
          .agg(n=agg.count(), top=agg.topk("safety_level", 3)))
    # until every row is visible: the workers lag the throttled intake
    lat, checks, matched, last_live = [], 0, 0, -1
    deadline = time.monotonic() + 600
    while ((h2.intake is not None and h2.intake.is_alive())
           or last_live < live_total) and time.monotonic() < deadline:
        with StoreSnapshot(h2.storage) as snap:
            t0 = time.perf_counter()
            r1 = qd.execute(snapshot=snap)
            wall = time.perf_counter() - t0
            r2 = qd.execute(prune=False, snapshot=snap)
            live = snap.live_rows
        assert_same(r1, r2, "(d) pruned vs unpruned")
        if on_card(h2.storage) and r1.stats.agg_fallback_dispatches:
            raise AssertionError("(d) a query took a plain version")
        if live < last_live:
            raise AssertionError("(d) live rows went backwards")
        last_live = live
        checks += 1
        if r1.stats.rows_matched:        # the latency of a real query
            matched += 1
            lat.append(wall)
        time.sleep(0.02)
    upd.stop()
    upd.join(timeout=10)
    st2 = h2.join(timeout=600)
    if st2.stored != live_total:
        raise AssertionError(f"(d) stored {st2.stored} of {live_total}")
    snap_t = table.snapshot()
    a = snap_t.arrays
    tkeys, tlvl = a["key"][:snap_t.size], a["safety_level"][:snap_t.size]
    rows = h2.query().select("id", "country", "safety_level").execute()
    at = np.clip(np.searchsorted(tkeys, rows["country"]), 0,
                 len(tkeys) - 1)
    want = np.where(tkeys[at] == rows["country"], tlvl[at], -1)
    bad = int((rows["safety_level"] != want).sum())
    if rows.rows != live_total or bad or checks == 0:
        raise AssertionError(f"(d) {bad} of {rows.rows} stored rows differ "
                             f"from the final table ({checks} checks)")
    shutil.rmtree(spill, ignore_errors=True)
    lat.sort()
    live_res = {"checks": checks, "checks_with_rows": matched,
                "updates": upd.updates,
                "repaired_rows": st2.repaired_rows,
                "compacted_rows": st2.compacted_rows,
                "query_p50_ms": 1e3 * lat[len(lat) // 2] if lat else None,
                "query_max_ms": 1e3 * lat[-1] if lat else None}
    log(f"read: (d) {checks} pruned/unpruned checks during ingest "
        f"({matched} with matching rows), "
        f"{upd.updates} reference updates, repaired "
        f"{st2.repaired_rows}, compacted {st2.compacted_rows}; all "
        f"{rows.rows} rows equal the final table; pruned query p50 "
        f"{live_res['query_p50_ms']} ms, max {live_res['query_max_ms']} "
        "ms over the checks with matching rows")
    return {"fill_s": fill_s, "segments": segs,
            "segments_merged": merged_segs, "merge_s": merge_s,
            "queries": rp.walls, "live": live_res,
            "groups_c": int(keys.shape[0])}


# ---------------------------------------------------------------------------
# phase 14: the durable, elastic feed of the whole workload
# ---------------------------------------------------------------------------

# the paper's workload as three plans: Q1..Q7 fused, and the two safety
# checks apart (both write safety_check_flag, so they cannot share a plan)
WORKLOAD = {"A": ("q1", "q2", "q3", "q4", "q5", "q6", "q7"),
            "B": ("udf1",), "C": ("udf2",)}
# (b)'s stream is cut to 12 of (a)'s 20 frames (80,640 tweets) for time:
# each round pays a child interpreter and a full re-enrichment by repair.
# Its intake is throttled to a 10 s window: a checkpoint of plan A under
# load takes ~2 s on an H100, so most kill points follow one
CRASH_FRAMES, CRASH_RATE, CRASH_ROUNDS = 12, 8_064.0, 2
SEED_CRASH = 100
# (c): a scaled feed over the first 8 of (a)'s frames (intake throttled
# so the scale-up lands mid-stream), a drain over 6
SCALE_FRAMES, SCALE_RATE, DRAIN_FRAMES = 8, 20_000.0, 6
UPDATE_EVERY, UPDATE_KEYS = 0.1, 25
Q1_Q5_COLUMNS = ("safety_level", "nearby_facility_counts",
                 "nearby_religious_buildings", "nearby_building_religions",
                 "suspect_threat_level", "suspect_religion")


def workload_udf(key):
    from repro_torch.core.enrich import queries as Q
    udfs = [Q.get_udf(n) for n in WORKLOAD[key]]
    return udfs[0] if len(udfs) == 1 else Q.chain(f"plan_{key}", *udfs)


def workload_plan(key, adapter, name, partitions=2, **store_kw):
    from repro_torch.core import pipeline
    return (pipeline(adapter, name).parse(batch_size=BATCH)
            .options(num_partitions=partitions)
            .enrich(workload_udf(key)).store(**store_kw))


def durable_plan(durable_dir, seed, rate=None):
    """Plan A, durable (WAL + checkpoints) with repair: the child runs it,
    the parent resumes it (same seed and frame size; replay is
    unthrottled)."""
    from repro_torch.core import DurableSpec, RepairSpec, SyntheticAdapter
    return workload_plan(
        "A", SyntheticAdapter(total=CRASH_FRAMES * BATCH, frame_size=BATCH,
                              seed=seed, rate=rate), "durable",
        durable=DurableSpec(dir=durable_dir, checkpoint_interval_s=0.5),
        refresh=RepairSpec(budget_rows_s=100_000.0))


def name_values(rng, n):
    return {"religion": rng.integers(0, 64, n).astype(np.int32),
            "threat_level": rng.integers(1, 11, n).astype(np.int32)}


def start_updaters(store, seed):
    """Rolling upserts to the two tables repair re-enriches from (Q1's
    safety_levels, Q5's suspicious_names), every UPDATE_EVERY s."""
    sn = store["suspicious_names"].snapshot()
    ups = [RollingUpdater(store["safety_levels"],
                          np.arange(len(store["safety_levels"])),
                          UPDATE_EVERY, UPDATE_KEYS, seed=seed),
           RollingUpdater(store["suspicious_names"],
                          sn.arrays["key"][:sn.size], UPDATE_EVERY,
                          UPDATE_KEYS, seed=seed + 1, values=name_values)]
    for u in ups:
        u.start()
    return ups


def stop_updaters(ups):
    for u in ups:
        u.stop()
    for u in ups:
        u.join(timeout=10)
    return sum(u.updates for u in ups)


def plan_rows(feed):
    cols = [c for c in feed.plan.output_columns if c != "valid"]
    res = feed.query().select(*cols).execute()
    order = np.argsort(res["id"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in res.items()}


def diff_columns(rows, want, at):
    """{column: rows that differ} between ``rows`` at ``at`` and ``want``."""
    bad = {}
    for k in want:
        a, b = rows[k][at], want[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            bad[k] = f"{a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        elif not np.array_equal(a, b):
            bad[k] = int((a != b).reshape(len(a), -1).any(1).sum())
    return bad


def cpu_enrichment(store, udf, seed, frames, cols):
    """A CPU ComputingRunner over the first ``frames`` frames of the
    stream, valid rows sorted by id, restricted to ``cols``."""
    from repro_torch.core import (ComputingRunner, ComputingSpec,
                                  SyntheticAdapter)
    runner = ComputingRunner(ComputingSpec(udf, BATCH, refresh="version"),
                             store, device="cpu")
    ad = SyntheticAdapter(total=frames * BATCH, frame_size=BATCH, seed=seed)
    outs = [runner.run(frame) for frame in ad.frames()]
    cpu = {k: np.concatenate([o[k][o["valid"]] for o in outs])
           for k in cols}
    order = np.argsort(cpu["id"], kind="stable")
    return {k: v[order] for k, v in cpu.items()}


def held_to_cpu(store, udf, rows, seed, what, smi, frames=CHECK_FRAMES,
                cols=None):
    """The stored ``rows`` of the first ``frames`` frames against a CPU
    enrichment: every column in ``cols`` (default all) equal."""
    t0 = time.perf_counter()
    cpu = cpu_enrichment(store, udf, seed, frames, cols or list(rows))
    cpu_s = time.perf_counter() - t0
    at = np.searchsorted(rows["id"], cpu["id"])
    if not np.array_equal(rows["id"][np.minimum(at, len(rows["id"]) - 1)],
                          cpu["id"]):
        raise AssertionError(f"{what}: CPU ids missing from the store")
    bad = diff_columns(rows, cpu, at)
    if bad:
        raise AssertionError(f"{what}: columns differ from the CPU: {bad}")
    log(f"{what}: {len(cpu['id'])} rows of {frames} frames equal the CPU "
        f"in {len(cpu)} columns (CPU run {cpu_s:.1f} s) [{smi}]")
    return len(cpu["id"])


def batch_layers(dev, store, udf, nbatch=2):
    """One thread's ComputingRunner on the card over ``nbatch`` frames,
    first use excluded: once under torch.profiler (the device's busy
    share of a batch), once with every batch calibrated (each fused stage
    replayed alone and timed, ``ComputingRunner._calibrate_stages``): ms
    per batch of each stage's state build and apply."""
    from repro_torch.core import (ComputingRunner, ComputingSpec,
                                  SyntheticAdapter)
    from repro_torch.core.computing import ComputingStats
    frames = list(SyntheticAdapter(total=(nbatch + 1) * BATCH,
                                   frame_size=BATCH,
                                   seed=SEED_STREAM).frames())
    runner = ComputingRunner(ComputingSpec(udf, BATCH), store, device=dev)
    runner.run(frames[0])
    prof, wall_ms = profiled_seen(lambda: [runner.run(f)
                                           for f in frames[1:]])
    dev_ms = kernel_device_ms(prof)
    runner.CALIBRATE_EVERY = 1
    runner.stats = ComputingStats()
    for f in frames[1:]:
        runner.run(f)
    stage_ms = {n: {"state_ms": st.state_s / nbatch * 1e3,
                    "apply_ms": st.apply_s / nbatch * 1e3}
                for n, st in runner.stats.per_stage.items()}
    return {"batches": nbatch, "profiled_wall_ms": wall_ms,
            "device_busy_ms": dev_ms, "device_busy_share": dev_ms / wall_ms,
            "stage_ms_per_batch": stage_ms}


def expected_workload_launches(key, c):
    """Plan A per invocation: Q1's and Q5's probes, Q4's, Q5's and Q7's
    joins (calibration replays each stage once more); per Q6 state build
    the income probe and two counts, per Q2 build one int64 sum.  Q3's
    top-3 over 50,000 countries runs plain on the card.  B and C (the
    safety checks) launch nothing."""
    want = dict.fromkeys(("hash_probe", "spatial_join", "segment_reduce",
                          "segment_topk", "flash_attention"), 0)
    if key != "A":
        return want, {}
    inv = c.invocations + c.calibrations
    b2, b3, b6 = (c.per_stage[n].state_builds for n in (
        "q2_religious_population", "q3_largest_religions",
        "q6_tweet_context"))
    want.update(hash_probe=2 * inv + b6, spatial_join=3 * inv,
                segment_reduce=b2 + 2 * b6)
    return want, {("segment_topk", "plain_on_card"): b3}


def run_workload(dev, store, key, smi, frames=FRAMES):
    """(a): one plan of the workload through FeedManager on the card, its
    launches held to the path's, then its first frames to the CPU."""
    from repro_torch.core import FeedManager, SyntheticAdapter
    from repro_torch.kernels import launch_counts, path_stats
    total = frames * BATCH
    before, pbefore = launch_counts(), path_stats()
    t0 = time.perf_counter()
    h = FeedManager(store, device=dev).submit(workload_plan(
        key, SyntheticAdapter(total=total, frame_size=BATCH,
                              seed=SEED_STREAM), f"workload_{key}"))
    stats = h.join(timeout=900)
    wall = time.perf_counter() - t0
    if stats.stored != total:
        raise AssertionError(f"plan {key}: stored {stats.stored} of {total}")
    after, pafter = launch_counts(), path_stats()
    counts = {k: after[k] - before[k] for k in after}
    # the card's top-k paths (plan validation on meta tensors records
    # "reference")
    paths = {p: n - pbefore.get(p, 0) for p, n in pafter.items()
             if n != pbefore.get(p, 0) and p[0] == "segment_topk"
             and p[1] != "reference"}
    c = stats.computing
    want, want_paths = expected_workload_launches(key, c)
    stages = {n: {"state_s": st.state_s, "state_builds": st.state_builds,
                  "invocations": st.invocations}
              for n, st in c.per_stage.items()}
    log(f"workload {key} ({' > '.join(WORKLOAD[key])}): {total} tweets in "
        f"{wall:.3f} s = {total / wall:,.0f} records/s; invocations "
        f"{c.invocations}, parse_s={c.parse_s:.3f} upload_s="
        f"{c.upload_s:.3f} convert_s={c.convert_s:.3f} state_s="
        f"{c.state_s:.3f} apply_s={c.apply_s:.3f} [{smi}]")
    built = [f"{n} {st['state_builds']} ({st['state_s']:.3f})"
             for n, st in stages.items() if st["state_builds"]]
    if built:
        log(f"workload {key}: state builds by stage (feed, seconds): "
            + ", ".join(built) + f" [{smi}]")
    log(f"workload {key}: launches {counts} (expected {want}); top-k "
        f"paths {paths} (expected {want_paths}) [{smi}]")
    if counts != want or paths != want_paths:
        raise AssertionError(f"plan {key}: launches {counts}, paths {paths}"
                             f" != {want}, {want_paths}")
    rows = plan_rows(h)
    checked = held_to_cpu(store, workload_udf(key), rows, SEED_STREAM,
                          f"workload {key} cross-check", smi)
    busy = batch_layers(dev, store, workload_udf(key))
    log(f"workload {key}: one thread, {busy['batches']} batches profiled: "
        f"device busy {busy['device_busy_ms']:.2f} ms of "
        f"{busy['profiled_wall_ms']:.2f} ms wall = "
        f"{busy['device_busy_share']:.4f} [{smi}]")
    log(f"workload {key}: one thread, ms per batch by stage (state, "
        "apply; each stage timed alone): " + ", ".join(
            f"{n} {v['state_ms']:.2f} {v['apply_ms']:.2f}"
            for n, v in busy["stage_ms_per_batch"].items()) + f" [{smi}]")
    return rows, {"wall_s": wall, "records_per_s": total / wall,
                  "invocations": c.invocations, "parse_s": c.parse_s,
                  "upload_s": c.upload_s, "convert_s": c.convert_s,
                  "state_s": c.state_s, "apply_s": c.apply_s,
                  "stages": stages, "launches": counts,
                  "topk_paths": {f"{p[0]}:{p[1]}": n
                                 for p, n in paths.items()},
                  "cross_checked_rows": checked, "busy": busy}


def replay_adapter(frames):
    """Pre-drawn frames at memory speed: a backlog in every holder."""
    from repro_torch.core.intake import Adapter

    class Replay(Adapter):
        def frames(self):
            for f in frames:
                if self._stop.is_set():
                    return
                yield f
    return Replay()


def elastic_feeds(dev, store, rows_a, smi):
    """(c): plan A scaled up by 2 partitions mid-stream, bitwise equal by
    id to (a)'s unscaled rows; then a feed of 3 partitions scaled down by
    one under a backlog, which must store every tweet exactly once."""
    from repro_torch.core import FeedManager, SyntheticAdapter
    mgr = FeedManager(store, device=dev)
    total = SCALE_FRAMES * BATCH
    t0 = time.perf_counter()
    h = mgr.submit(workload_plan("A", SyntheticAdapter(
        total=total, frame_size=BATCH, seed=SEED_STREAM, rate=SCALE_RATE),
        "scaled"))
    added = h.scale_up(2)
    stats = h.join(timeout=900)
    wall = time.perf_counter() - t0
    peak = stats.peak_partitions[h.stage_groups[0].name]
    if added != 2 or peak != 4 or stats.stored != total:
        raise AssertionError(f"scale_up: added {added}, peak {peak}, "
                             f"stored {stats.stored} of {total}")
    rows = plan_rows(h)
    head = {k: v[:total] for k, v in rows_a.items()}
    if not np.array_equal(head["id"], rows["id"]):
        raise AssertionError("scale_up: stored ids differ from (a)'s")
    bad = diff_columns(rows, head, np.arange(total))
    if bad:
        raise AssertionError(f"scale_up: columns differ from (a): {bad}")
    log(f"elastic: scale_up(2) mid-feed, peak {peak} partitions, {total} "
        f"rows bitwise equal to (a)'s in {len(rows)} columns; "
        f"{total / wall:,.0f} records/s [{smi}]")
    frames = list(SyntheticAdapter(total=DRAIN_FRAMES * BATCH,
                                   frame_size=BATCH,
                                   seed=SEED_STREAM + 3).frames())
    total2 = DRAIN_FRAMES * BATCH
    h2 = mgr.submit(workload_plan("A", replay_adapter(frames), "drain",
                                  partitions=3))
    time.sleep(0.2)                   # let the holders fill
    dropped = h2.scale_down(1)
    stats2 = h2.join(timeout=900)
    ids = np.sort(np.asarray(h2.query().select("id").execute()["id"]))
    if (dropped != 1 or stats2.stored != total2
            or not np.array_equal(ids, np.arange(total2))
            or stats2.computing.records != total2):
        raise AssertionError(f"scale_down: dropped {dropped}, stored "
                             f"{stats2.stored}, {len(ids)} ids of {total2}")
    log(f"elastic: scale_down(1) of 3 partitions under a backlog drained "
        f"{total2} tweets exactly once ({stats2.scale_downs} retired) "
        f"[{smi}]")
    return {"scaled_rows": total, "scale_up_added": added,
            "peak_partitions": peak, "scaled_wall_s": wall,
            "drained_rows": total2, "scale_down_dropped": dropped}


def durable_child(durable_dir, seed) -> int:
    """The interpreter that gets killed: builds the tables, warms the card
    (one batch of plan A: context, kernels, first state builds), then runs
    the durable plan on the card under rolling upserts and says READY
    once its first batch is stored."""
    from repro_torch.core import (ComputingRunner, ComputingSpec,
                                  FeedManager, RefStore, SyntheticAdapter)
    from repro_torch.core.enrich import queries as Q
    from repro_torch.kernels import build_all
    store = RefStore()
    Q.make_reference_tables(store, scale=1.0, seed=SEED_TABLES)
    build_all()
    ComputingRunner(ComputingSpec(workload_udf("A"), BATCH), store,
                    device="cuda").run(next(SyntheticAdapter(
                        total=BATCH, frame_size=BATCH, seed=seed).frames()))
    h = FeedManager(store, device="cuda").submit(
        durable_plan(durable_dir, seed, rate=CRASH_RATE))
    ups = start_updaters(store, seed)
    # the ingest window opens with the first stored batch: the context,
    # the kernels' first loads and the first state builds lie before it
    while h.storage.count == 0:
        time.sleep(0.01)
    print("READY", flush=True)
    h.join(timeout=900)
    stop_updaters(ups)
    return 0


def start_child(durable_dir, seed):
    """``durable_child`` in a fresh interpreter (a CUDA context does not
    survive fork), once it says READY."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--durable-child",
         durable_dir, "--seed", str(seed)], stdout=subprocess.PIPE,
        text=True)
    for line in proc.stdout:
        if line.strip() == "READY":
            return proc
    raise AssertionError(f"crash child exited before READY "
                         f"(rc {proc.wait()})")


def live_ids(storage):
    """Every live pk across the partitions, duplicates included."""
    out = []
    for part in storage.partitions:
        snap = part.snapshot_view()
        try:
            for u in snap.units:
                ids = np.asarray(u.read(("id",))["id"])
                out.append(ids[snap.live_mask(ids, u.base)])
        finally:
            snap.release()
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def table_lookup(store, table, col, keys):
    snap = store[table].snapshot()
    a = snap.arrays
    tk, tv = a["key"][:snap.size], a[col][:snap.size]
    at = np.clip(np.searchsorted(tk, keys), 0, max(len(tk) - 1, 0))
    return np.where(tk[at] == keys, tv[at], -1).astype(tv.dtype)


def crash_round(dev, store, durable_dir, seed, rng, smi):
    """(b), one round: start the child, SIGKILL it at a seeded random
    point of its ingest window, resume on the card under rolling upserts,
    quiesce them, let repair converge; then no row lost or doubled, and
    every row's Q1 and Q5 columns current under the final tables."""
    from repro_torch.core import FeedManager
    from repro_torch.core.durability import CheckpointStore
    from repro_torch.core.enrich import queries as Q
    total = CRASH_FRAMES * BATCH
    proc = start_child(durable_dir, seed)
    window = total / CRASH_RATE
    delay = float(rng.uniform(0.1 * window, 0.7 * window))
    try:
        time.sleep(delay)
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()
    ck = CheckpointStore(durable_dir).load() or {}
    t0 = time.perf_counter()
    h = FeedManager(store, device=dev).resume(
        durable_plan(durable_dir, seed))
    rt = h.durability
    backlog = rt.replayed_records
    ups = start_updaters(store, seed + 7)
    deadline = time.monotonic() + 600
    while (rt.ledger.watermark() < rt.replay_target_seq
           and time.monotonic() < deadline):
        time.sleep(0.005)
    recovery_s = time.perf_counter() - t0
    # upserts go on while the resumed intake runs, and at least 3 rounds
    while (((h.intake is not None and h.intake.is_alive())
            or min(u.updates for u in ups) < 3)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    updates = stop_updaters(ups)
    stats = h.join(timeout=900)
    wall = time.perf_counter() - t0
    ckpt = h.metrics()["checkpoint_s"]     # the resumed feed's checkpoints
    ids = live_ids(h.storage)
    uniq = np.unique(ids)
    lost, dups = total - len(uniq), len(ids) - len(uniq)
    if lost or dups or not h.repair.converged():
        raise AssertionError(f"crash round: lost {lost}, duplicated {dups},"
                             f" repair converged {h.repair.converged()}")
    rows = h.query().select("id", "country", "user_name_hash",
                            *Q1_Q5_COLUMNS).execute()
    order = np.argsort(rows["id"], kind="stable")
    rows = {k: np.asarray(v)[order] for k, v in rows.items()}
    want = {"safety_level": table_lookup(store, "safety_levels",
                                         "safety_level", rows["country"]),
            "suspect_threat_level": table_lookup(
                store, "suspicious_names", "threat_level",
                rows["user_name_hash"]),
            "suspect_religion": table_lookup(
                store, "suspicious_names", "religion",
                rows["user_name_hash"])}
    bad = diff_columns(rows, want, np.arange(len(rows["id"])))
    if bad:
        raise AssertionError(f"crash round: rows not current under the "
                             f"final tables: {bad}")
    checked = held_to_cpu(store, Q.Q1.then(Q.Q5), rows, seed,
                          "crash round: Q1 > Q5 vs CPU", smi,
                          cols=["id", *Q1_Q5_COLUMNS])
    log(f"crash round: SIGKILL at +{delay:.2f} s of a {window:.2f} s "
        f"window, the last checkpoint at frame {ck.get('watermark', 0)} "
        f"of {ck.get('last_seq', 0)} logged; replay backlog {backlog} "
        f"records; recovery {recovery_s:.3f} s (resume until the backlog "
        f"is re-stored); resumed feed {stats.records_in} records in, "
        f"{wall:.2f} s to converged, {ckpt.count} checkpoints of "
        f"{ckpt.sum / max(ckpt.count, 1):.3f} s mean, "
        f"{ckpt.percentile(1.0):.3f} s max; {updates} reference upserts, "
        f"repaired {stats.repaired_rows}; lost 0, duplicated 0; "
        f"{len(uniq)} rows current [{smi}]")
    return {"kill_after_s": delay, "window_s": window,
            "checkpoint_watermark": ck.get("watermark", 0),
            "checkpoint_last_seq": ck.get("last_seq", 0),
            "replay_backlog": backlog, "recovery_s": recovery_s,
            "resumed_records_in": stats.records_in,
            "wall_to_converged_s": wall, "updates": updates,
            "checkpoints": ckpt.count, "checkpoint_s_sum": ckpt.sum,
            "checkpoint_s_max": ckpt.percentile(1.0),
            "repaired_rows": stats.repaired_rows,
            "stale_rows": stats.stale_rows, "lost": lost, "duplicated": dups,
            "cpu_checked_rows": checked}


def durable_feed(dev, store, out_dir, smi):
    """Phase 14: (a) the three workload plans, (c) elasticity, then (b)
    the crash rounds (last: their upserts change the tables (a) and (c)
    are compared under)."""
    import shutil
    base = os.path.join(out_dir, "durable")
    shutil.rmtree(base, ignore_errors=True)
    res = {"plans": {}}
    for key in WORKLOAD:
        rows, res["plans"][key] = run_workload(dev, store, key, smi)
        if key == "A":
            rows_a = rows
    res["elastic"] = elastic_feeds(dev, store, rows_a, smi)
    rng = np.random.default_rng(29)
    try:
        res["crash"] = [crash_round(dev, store,
                                    os.path.join(base, f"round{r}"),
                                    SEED_CRASH + r, rng, smi)
                        for r in range(CRASH_ROUNDS)]
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 8: LM serving of deepseek-coder-33b at full width
# ---------------------------------------------------------------------------

SERVE_ARCH = "deepseek-coder-33b"
SERVE_LAYERS = 4             # of 62: depth is the only cut (5.2 GB of bf16)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_BUCKET = 4, 2048, 16
SERVE_REQUESTS, SERVE_NEW = 12, 32
SERVE_PROMPT_LEN = (256, 1536)
SERVE_SEED = 0
# 200 tokens: four 64-key tiles, so the online softmax rescales and the
# kernel skips causal tiles inside the model's cross-check
CHECK_PROMPTS, CHECK_STEPS = (32, 40, 200), 8
# Card against CPU, in units of the CPU logits' std at each step.  This
# random-init model's attention is near one-hot (scores have std ~339 under
# the init rule), so a rounding-level difference flips some heads and the
# two devices' logits spread although both are right.
# scripts/serve_logit_spread.py measures that spread on the card at this
# configuration (3 trials of CHECK_PROMPTS; NVIDIA H100 80GB HBM3, 700 W):
# sound, the worst max|d|/std is 2.9736, rms/std 0.7398, greedy gap/std
# 3.0868; with the query heads in the wrong GQA order, each faulty trial's
# largest readings are at least 5.8496, 1.3787 and 5.3047.  The limits lie
# between the two.
SERVE_TOL = 4.2              # max |d logit| / std, and the greedy gap
SERVE_RMS_TOL = 1.0          # rms(d logit) / std


def serve_requests(cfg, n=SERVE_REQUESTS, new=SERVE_NEW, multiple=1,
                   lens=SERVE_PROMPT_LEN):
    """``n`` prompts of ``lens`` (default 256-1,536) tokens (multiples of
    ``multiple``) from a seeded numpy generator, ``new`` tokens each."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(SERVE_SEED + 1)
    lo, hi = (x // multiple for x in lens)
    return [Request(rng.integers(16, cfg.vocab_size,
                                 int(rng.integers(lo, hi + 1)) * multiple
                                 ).tolist(),
                    max_new_tokens=new, stop_at_eos=False)
            for _ in range(n)]


def serve_warmup(cfg, params, dev):
    """One short prefill, apply and decode step: the first cuBLAS calls
    of each shape, outside the measured run."""
    from repro_torch.models import api
    tok = torch.full((1, 16), 17, dtype=torch.int32, device=dev)
    cache, logits = api.prefill(cfg, params, tok)
    api.apply(cfg, params, {"tokens": tok})
    api.decode_step(cfg, params, api.pad_cache(cfg, cache, 32),
                    logits.argmax(-1, keepdim=True).int())
    torch.cuda.synchronize()


def serve_path(cfg, params, dev, requests=None, tag="serve",
               max_len=SERVE_MAX_LEN):
    """The continuous-batching engine over ``requests`` (default:
    serve_requests(cfg))."""
    from repro_torch.serve import ServingEngine
    eng = ServingEngine(cfg, params, slots=SERVE_SLOTS,
                        max_len=max_len, prompt_bucket=SERVE_BUCKET,
                        device=dev)
    reqs = [eng.submit(r) for r in (requests or serve_requests(cfg))]
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != len(reqs) or any(
            len(r.tokens) != r.max_new_tokens
            or not all(0 <= x < cfg.vocab_size for x in r.tokens)
            for r in reqs):
        raise AssertionError(f"{tag}: a request did not get its new "
                             "tokens")
    new = sum(len(r.tokens) for r in reqs)
    prompt = sum(len(r.prompt) for r in reqs)
    res = {"requests": len(done), "prompt_tokens": prompt,
           "new_tokens": new, "wall_s": wall, "prefills": eng.prefills,
           "decode_steps": eng.decode_steps,
           "prefill_ms_per_request": eng.prefill_s / eng.prefills * 1e3,
           "decode_ms_per_step": eng.decode_s / eng.decode_steps * 1e3,
           "new_tokens_per_s": new / wall,
           "prompt_and_new_tokens_per_s": (prompt + new) / wall}
    log(f"{tag}: {len(done)} requests ({prompt} prompt tokens, {new} new) "
        f"in {wall:.3f} s on {SERVE_SLOTS} slots: "
        f"{res['new_tokens_per_s']:.1f} new tokens/s; prefill "
        f"{res['prefill_ms_per_request']:.2f} ms per request (prefill, "
        f"first-token read, splice), decode "
        f"{res['decode_ms_per_step']:.2f} ms per step over "
        f"{eng.decode_steps} steps")
    return res


def profile_serving(cfg, params, dev, n=SERVE_PROMPT_LEN[1], flash=True,
                    tag="serve", max_len=SERVE_MAX_LEN):
    """Under torch.profiler: one prefill of the longest prompt and one
    apply of it, a forward over every position (the flash kernel's
    device time against all
    kernels' and the wall; with ``flash``, all of it must be the wgmma
    body's), and one decode step of all slots over n-token caches
    (device busy share)."""
    from repro_torch.models import api
    from repro_torch.models.params import tree_map
    tok = torch.randint(16, cfg.vocab_size, (1, n), dtype=torch.int32,
                        device=dev)
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                           device=dev),
                     api.cache_specs(cfg, SERVE_SLOTS, max_len)[0])
    step = torch.full((SERVE_SLOTS, 1), 17, dtype=torch.int32, device=dev)
    runs = {"prefill": lambda: api.prefill(cfg, params, tok),
            "apply": lambda: api.apply(cfg, params, {"tokens": tok})}
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        prof, wall_ms = profiled_seen(fn)
        dev_ms, flash_ms = kernel_device_ms(prof), kernel_device_ms(
            prof, "flash_")
        wgmma_ms = kernel_device_ms(prof, "flash_wgmma")
        if not (0 < wgmma_ms == flash_ms if flash else flash_ms == 0):
            raise AssertionError(f"{tag}: {name}'s flash kernels ran "
                                 f"{flash_ms:.3f} ms on the device, "
                                 f"{wgmma_ms:.3f} ms of it the wgmma body")
        out[name] = {"tokens": n, "wall_ms": wall_ms, "device_ms": dev_ms,
                     "flash_ms": flash_ms,
                     "flash_share_of_device": flash_ms / dev_ms,
                     "device_busy_share": dev_ms / wall_ms}
        log(f"{tag}: {name} of {n} tokens profiled: flash kernel "
            f"{flash_ms:.3f} ms of {dev_ms:.3f} ms device time (share "
            f"{flash_ms / dev_ms:.4f}), wall {wall_ms:.2f} ms, device busy "
            f"{dev_ms / wall_ms:.4f}")

    def decode():
        cache["len"].fill_(n)
        api.decode_step(cfg, params, cache, step)
    decode()
    torch.cuda.synchronize()
    prof, wall_ms = profiled_seen(decode)
    dev_ms = kernel_device_ms(prof)
    out["decode_step"] = {"slots": SERVE_SLOTS, "cache_len": n,
                          "wall_ms": wall_ms, "device_ms": dev_ms,
                          "device_busy_share": dev_ms / wall_ms}
    log(f"{tag}: decode step of {SERVE_SLOTS} slots at length {n} "
        f"profiled: device {dev_ms:.3f} ms of {wall_ms:.2f} ms wall, "
        f"device busy {dev_ms / wall_ms:.4f}")
    return out


# This model's attention scores have a std of hundreds, so most rows'
# softmax is one-hot, but where a few keys' scores nearly tie, p spreads
# over values of either sign and the output cancels: rounding each p_j to
# bf16 (2^-9 of p_j, before or after normalising) then errs by up to
# 2^-9 * sum_j p_j |v_jd|, far beyond tol * (1 + |o_d|).  P_REL allows
# twice that.
P_REL = 2.0 ** -8


def attention_error_bound(q, k, v, causal, outs, tol):
    """Each output of ``outs`` (B = 1) against a float64 oracle of the same
    bf16 inputs, per element: |out - o| <= tol * (1 + |o|) + P_REL *
    (p @ |v|).  Returns per output: max |out - o|, the elements beyond
    tol * (1 + |o|) alone, and the largest |out - o| / bound (<= 1
    holds)."""
    _, s, h, d = q.shape
    t_, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    keep = (torch.arange(s, device=q.device)[:, None]
            >= torch.arange(t_, device=q.device)[None]) if causal else None
    res = {name: {"max_err": 0.0, "beyond_tol": 0, "ratio": 0.0}
           for name in outs}
    for kv in range(kvh):
        qg = q[0, :, kv * g:(kv + 1) * g].double()          # (S, G, D)
        kg, vg = k[0, :, kv].double(), v[0, :, kv].double()  # (T, D)
        sc = torch.einsum("sgd,td->gst", qg, kg) * d ** -0.5
        if causal:
            sc = sc.masked_fill(~keep, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        del sc
        o = p @ vg                                           # (G, S, D)
        plain_tol = tol * (1 + o.abs())
        bound = plain_tol + P_REL * (p @ vg.abs())
        del p
        for name, y in outs.items():
            err = (y[0, :, kv * g:(kv + 1) * g].double().transpose(0, 1)
                   - o).abs()
            r = res[name]
            r["max_err"] = max(r["max_err"], float(err.max()))
            r["beyond_tol"] += int((err > plain_tol).sum())
            r["ratio"] = max(r["ratio"], float((err / bound).max()))
    return res


def serve_attention_check(cfg, params, dev, n=SERVE_PROMPT_LEN[1]):
    """Every layer's roped q, k, v of an n-token prefill on the card: the
    kernel and the plain version each held to a float64 oracle within
    attention_error_bound (phase 3's N(0, 1) inputs have no sharp
    softmax and no such cancellation)."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    from repro_torch.models import api
    seen, orig = [], ops.flash_attention

    def capture(q, k, v, causal=True):
        seen.append((q, k, v, causal))
        return orig(q, k, v, causal)
    tok = torch.randint(16, cfg.vocab_size, (1, n), dtype=torch.int32,
                        device=dev, generator=torch.Generator(
                            device=dev).manual_seed(SERVE_SEED + 3))
    ops.flash_attention = capture
    try:
        api.prefill(cfg, params, tok)
    finally:
        ops.flash_attention = orig
    if len(seen) != cfg.num_layers:
        raise AssertionError(f"prefill made {len(seen)} attention calls, "
                             f"not {cfg.num_layers}")
    out = []
    for i, (q, k, v, causal) in enumerate(seen):
        tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
        got = kernel.flash_attention(q, k, v, causal)
        want = ref.flash_attention(q, k, v, causal)
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"serve attention layer {i}: kernel output "
                                 "not finite")
        g = q.shape[2] // k.shape[2]
        # head group 0's causal scores, as the kernel scales them
        sc = torch.einsum("sgd,td->gst", q[0, :, :g].float(),
                          k[0, :, 0].float()) * q.shape[-1] ** -0.5
        sd = float(sc[:, torch.ones(n, n, dtype=torch.bool,
                                    device=dev).tril()].std())
        del sc
        vs_plain = float((got.float() - want.float()).abs().max())
        res = attention_error_bound(q, k, v, causal,
                                    {"kernel": got, "plain": want}, tol)
        body = kernel.body(q.dtype, q.shape[3])
        out.append({"layer": i, "body": body, "scores_std": sd,
                    "kernel_vs_plain_max": vs_plain, **res})
        log(f"serve attention layer {i} (S=T={n} H={q.shape[2]} "
            f"Kv={k.shape[2]} D={q.shape[3]}, body {body}): scores std "
            f"{sd:.1f}; "
            f"max |kernel - plain| {vs_plain:.4g}; against float64: "
            + "; ".join(
                f"{name} max err {r['max_err']:.4g}, {r['beyond_tol']} "
                f"elements beyond {tol} * (1 + |o|), err / bound "
                f"{r['ratio']:.4f}"
                for name, r in res.items()))
        if body != "wgmma":
            raise AssertionError(f"serve attention layer {i}: the {body} "
                                 "body, not wgmma")
        bad = [name for name, r in res.items() if not r["ratio"] <= 1.0]
        if bad:
            raise AssertionError(f"serve attention layer {i}: {bad} beyond "
                                 "the error bound of a float64 oracle")
    return out


def cross_check_readings(cfg, params, cpu_params, dev, prompts, seed):
    """Prompts of the given lengths (from ``seed``) on the card, greedy for
    CHECK_STEPS decode steps; the same prompts on the CPU, fed the card's
    tokens.  The encdec family's prefill gets seeded N(0, 1) frames (the
    same on both devices), so that its cross-attention is not uniform.
    Per prompt and step, in units of the CPU logits' std: max and rms of
    card - CPU, and the CPU's best logit minus its logit at the card's
    token (greedy gap)."""
    from repro_torch.models import api
    rng = np.random.default_rng(seed)
    out = []
    for plen in prompts:
        prompt = rng.integers(16, cfg.vocab_size, (1, plen)).astype(np.int32)
        frames = None
        if cfg.family == "encdec":
            frames = rng.normal(size=(1, cfg.num_frontend_tokens,
                                      cfg.d_model)).astype(np.float32)
        cache, logits = api.prefill(
            cfg, params, t(prompt, dev),
            None if frames is None else t(frames, dev))
        cache = api.pad_cache(cfg, cache, plen + CHECK_STEPS + 1)
        card, toks = [], []
        for i in range(CHECK_STEPS + 1):
            card.append(logits[0].float().cpu())
            toks.append(int(torch.argmax(logits[0])))
            if i < CHECK_STEPS:
                logits, cache = api.decode_step(
                    cfg, params, cache, torch.tensor(
                        [[toks[-1]]], dtype=torch.int32, device=dev))
        ccache, clog = api.prefill(
            cfg, cpu_params, torch.from_numpy(prompt),
            None if frames is None else torch.from_numpy(frames))
        ccache = api.pad_cache(cfg, ccache, plen + CHECK_STEPS + 1)
        for i in range(CHECK_STEPS + 1):
            want = clog[0].float()
            sd = float(want.std())
            d = card[i] - want
            out.append({"prompt": plen, "step": i,
                        "max": float(d.abs().max()) / sd,
                        "rms": float(d.pow(2).mean().sqrt()) / sd,
                        "greedy_gap": (float(want.max())
                                       - float(want[toks[i]])) / sd})
            if i < CHECK_STEPS:
                clog, ccache = api.decode_step(
                    cfg, cpu_params, ccache,
                    torch.tensor([[toks[i]]], dtype=torch.int32))
    return out


def serve_cross_check(cfg, params, dev):
    """CHECK_PROMPTS teacher-forced on the CPU from the same weights: at
    every step the card's logits are held to the CPU's, and the card's
    greedy token to the CPU's best logit (SERVE_TOL, SERVE_RMS_TOL)."""
    from repro_torch.models.params import tree_map
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda x: x.cpu(), params)
    rows = cross_check_readings(cfg, params, cpu_params, dev, CHECK_PROMPTS,
                                SERVE_SEED + 2)
    for r in rows:
        if not (r["max"] <= SERVE_TOL and r["rms"] <= SERVE_RMS_TOL
                and r["greedy_gap"] <= SERVE_TOL):
            raise AssertionError(
                f"serve cross-check: prompt {r['prompt']} step {r['step']}: "
                f"card vs CPU max|d|/std {r['max']:.3f} (tol {SERVE_TOL}), "
                f"rms/std {r['rms']:.3f} (tol {SERVE_RMS_TOL}), greedy "
                f"gap/std {r['greedy_gap']:.3f}")
    worst = {k: max(r[k] for r in rows) for k in ("max", "rms",
                                                  "greedy_gap")}
    cpu_s = time.perf_counter() - t0
    log(f"serve cross-check: prompts {CHECK_PROMPTS} x {CHECK_STEPS} "
        f"decode steps, card vs CPU (teacher-forced): worst max|d|/std "
        f"{worst['max']:.4f}, rms/std {worst['rms']:.4f}, greedy gap/std "
        f"{worst['greedy_gap']:.4f} (tol {SERVE_TOL} / {SERVE_RMS_TOL}); "
        f"{cpu_s:.1f} s")
    return {**worst, "seconds": cpu_s}


# ---------------------------------------------------------------------------
# phase 9: LM training of deepseek-coder-33b at full width
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4             # of 62, as serving
TRAIN_SEQ, TRAIN_BATCH = 4096, 2   # deepseek-coder's 4,096-token window
TRAIN_WARM, TRAIN_TIMED = 2, 10
TRAIN_LR = 3.5e-4            # deepseek-coder 33B's peak learning rate
TRAIN_SEED = 0
TRAIN_FRAMES = 2             # 13,440 tweets: ~19 batches of 8,192 tokens
# the cross-check: 1 of 62 layers at full width, one packed row of 1,024
# tokens, so the attention (blocks of 512) and the cross-entropy (chunks
# of 512) both chunk
CHECK_LAYERS, CHECK_SEQ = 1, 1024
# Card against CPU after one step from the same state (bf16 parameters):
# |d loss|, |d grad_norm| / grad_norm, and per leaf |d update| / |update|
# (update = new - old parameters), its largest over the leaves.
# scripts/train_step_spread.py measured them at this configuration (3
# trials; NVIDIA H100 80GB HBM3, 700 W): sound, at most 1.54e-4, 8.94e-3
# and 0.660 (bf16 rounds each new parameter to within an ulp, ~1/6 of
# the update); with the attention output detached, each trial's
# grad_norm at least 0.910 and update 26.6 (its loss is the sound one:
# the forward is unchanged); with the segment mask dropped, at least
# 0.0173, 0.829 and 1.196.  The limits lie between the two.
TRAIN_CHECK_TOL = {"loss": 0.005, "grad_norm": 0.1, "update": 0.9}


def train_model_flops(cfg, seq: int) -> float:
    """Model FLOPs per token of one training step: 6 x parameters (forward
    and backward of every weight) plus causal attention's 6 * L * H * D *
    S (QK^T and PV over S/2 keys on average, 2 FLOPs each, times 3)."""
    from repro_torch.models import api
    return (6.0 * api.param_count(cfg) + 6.0 * cfg.num_layers
            * cfg.num_heads * cfg.resolved_head_dim * seq)


def train_source(store, dev, cfg, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                 frames=TRAIN_FRAMES, frame=BATCH):
    """The LM data plane over the phase-4 tables: UDF2 (the
    SensitiveWords join) -> tokenize -> safe-only filter -> packer, 2
    partitions, on ``dev``."""
    from repro_torch.core import FeedManager
    from repro_torch.train.data_feed import FeedDataSource
    return FeedDataSource(FeedManager(store, device=dev),
                          vocab_size=cfg.vocab_size, seq_len=seq,
                          batch_size=batch, total_records=frames * frame,
                          frame_size=frame, safety_filter=True,
                          num_partitions=2, seed=SEED_STREAM)


def packed_row(seq, seed=0, vocab=512):
    """One packed row of tweet-sized documents (5-16 tokens) drawn from a
    seeded numpy stream (the CPU-sized stand-in for the data plane's)."""
    from repro_torch.data.packing import StreamPacker
    rng = np.random.default_rng(seed)
    packer = StreamPacker(seq, 1)
    while True:
        out = packer.add(rng.integers(16, vocab, int(rng.integers(5, 17)))
                         .tolist())
        if out is not None:
            return out


def check_grads(grads) -> dict:
    """Every leaf's gradient finite and not all zero (a detached attention
    leaves wq, wk and wv with zeros); returns each leaf's norm."""
    from repro_torch.models.params import tree_flatten
    leaves, struct = tree_flatten(grads)
    norms = {}
    for name, g in zip(_leaf_names(struct), leaves):
        n = float(torch.linalg.vector_norm(g.float()))
        norms[name] = n
        if not bool(torch.isfinite(g).all()) or not n > 0:
            raise AssertionError(f"train: the gradient of {name} is not "
                                 f"finite or all zero (norm {n})")
    return norms


def _leaf_names(struct, prefix=""):
    if isinstance(struct, dict):
        for k, v in struct.items():
            yield from _leaf_names(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1]


def attention_share_ms(cfg, dev, seq=TRAIN_SEQ, batch=TRAIN_BATCH):
    """Device ms of one layer's training attention at the step's shape:
    the chunked forward alone (the checkpointed layer's first pass) and
    forward + backward with gradients (its recompute and backward)."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=dev).manual_seed(5)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.bfloat16)
    q, k, v = rnd(batch, seq, h, d), rnd(batch, seq, kv, d), \
        rnd(batch, seq, kv, d)
    pos = L.default_positions(batch, seq, dev)
    blk = L._pick_block(seq)

    def fwd():
        with torch.no_grad():
            L._chunked_gqa(cfg, q, k, v, pos, pos, None, None, blk, blk,
                           True)

    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def fwd_bwd():
        out = L._chunked_gqa(cfg, qg, kg, vg, pos, pos, None, None, blk,
                             blk, True)
        out.float().sum().backward()
    return {"forward_ms": time_ms(fwd, reps=3, warm=1),
            "forward_backward_ms": time_ms(fwd_bwd, reps=3, warm=1)}


def train_path(dev, store, cfg=None, seq=TRAIN_SEQ):
    """Trainer over the LM data plane: the first batch's gradients checked
    leaf by leaf, then TRAIN_WARM + TRAIN_TIMED steps.  Returns (the
    measurements, with the launch counts and attention paths read just
    after the run under "launches" and "paths"; the trainer; one more
    batch).  ``cfg`` and ``seq`` default to the phase's (a CPU rehearsal
    passes small ones)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, path_stats
    from repro_torch.models import api
    from repro_torch.train import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = cfg or get_config(SERVE_ARCH).replace(num_layers=TRAIN_LAYERS)
    steps = TRAIN_WARM + TRAIN_TIMED
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARM, total_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, opt, TrainerConfig(steps=steps, log_every=1,
                                              seed=TRAIN_SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.param_count(cfg)
    log(f"train: {SERVE_ARCH} at full width, {cfg.num_layers} of 62 layers, "
        f"{n_params:,} parameters ({cfg.param_dtype}), remat {cfg.remat}, "
        f"AdamW state {opt.state_dtype}: drawn in {init_s:.3f} s")
    source = train_source(store, dev, cfg, seq=seq)
    try:
        it = iter(source)
        t0 = time.perf_counter()
        first = next(it)
        first_wait = time.perf_counter() - t0
        loss, _, grads = trainer.step_fn.accumulate(trainer.state["params"],
                                                    first)
        norms = check_grads(grads)
        del grads
        log(f"train: first batch after {first_wait:.2f} s; its loss "
            f"{float(loss):.4f}, every one of {len(norms)} gradient leaves "
            f"finite and non-zero (norms {min(norms.values()):.4g} to "
            f"{max(norms.values()):.4g})")
        t0 = time.perf_counter()
        hist = trainer.run(itertools.chain([first], it))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spare = next(it)
    finally:
        source.close()
    res = {"launches": launch_counts(), "paths": path_stats()}
    losses = [h["loss"] for h in hist]
    if (int(trainer.state["step"]) != steps or len(hist) != steps
            or [h["step"] for h in hist] != list(range(1, steps + 1))
            or not all(np.isfinite(losses))):
        raise AssertionError(f"train: {int(trainer.state['step'])} steps "
                             f"of {steps}, losses {losses}")
    timed = trainer.step_times[TRAIN_WARM:]
    step_s = [t["data_wait_s"] + t["grad_s"] + t["update_s"] for t in timed]
    timed_wall = hist[-1]["wall_s"] - hist[TRAIN_WARM - 1]["wall_s"]
    tokens = TRAIN_BATCH * seq
    flops = train_model_flops(cfg, seq) * tokens
    med = float(statistics.median(step_s))
    res.update({"layers": cfg.num_layers, "parameters": n_params,
                "seq_len": seq, "batch": TRAIN_BATCH, "lr": TRAIN_LR,
                "steps": steps, "wall_s": wall, "init_s": init_s,
                "first_batch_wait_s": first_wait,
                "losses": losses,
                "loss_tokens": [h["tokens"] for h in hist],
                "grad_norms": [h["grad_norm"] for h in hist],
                "step_ms_median": med * 1e3,
                "data_wait_ms_median": statistics.median(
                    t["data_wait_s"] for t in timed) * 1e3,
                "forward_backward_ms_median": statistics.median(
                    t["grad_s"] for t in timed) * 1e3,
                "optimizer_ms_median": statistics.median(
                    t["update_s"] for t in timed) * 1e3,
                "step_times": trainer.step_times,
                "tokens_per_s": TRAIN_TIMED * tokens / timed_wall,
                "model_flops_per_token": flops / tokens,
                "train_mfu": flops / med / PEAK_BF16_S,
                "filtered_records": source.filtered,
                "gradient_norms_first_batch": norms})
    log(f"train: {steps} steps ({TRAIN_WARM} warm) of {TRAIN_BATCH} x "
        f"{seq} tokens in {wall:.2f} s: "
        f"{res['tokens_per_s']:.1f} tokens/s; step {med * 1e3:.1f} ms "
        f"(median) = data wait {res['data_wait_ms_median']:.2f} + forward + "
        f"backward {res['forward_backward_ms_median']:.1f} + optimizer "
        f"{res['optimizer_ms_median']:.1f}; train_mfu "
        f"{res['train_mfu']:.4f} ({res['model_flops_per_token'] / 1e9:.2f} "
        f"GFLOP a token over {PEAK_BF16_S / 1e12:.0f} TFLOP/s bf16)")
    log("train: loss per step " + ", ".join(f"{x:.4f}" for x in losses))
    return res, trainer, spare


def train_profile(res, trainer, batch, seq=TRAIN_SEQ):
    """One more step of ``trainer`` on ``batch`` profiled (device busy
    share), the peak memory, and one layer's attention timed alone
    (its share of the median step)."""
    cfg = trainer.model_cfg
    prof, prof_ms = profiled_seen(lambda: trainer.step_fn(trainer.state,
                                                          batch))
    dev_ms = kernel_device_ms(prof)
    res["profile"] = {"wall_ms": prof_ms, "device_ms": dev_ms,
                      "device_busy_share": dev_ms / prof_ms}
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del prof
    att = res["attention_layer"] = attention_share_ms(cfg, trainer.device,
                                                      seq)
    res["attention_share_of_step"] = cfg.num_layers * (
        att["forward_ms"] + att["forward_backward_ms"]) / res[
            "step_ms_median"]
    log(f"train: peak memory {res['peak_memory_bytes'] / 2**30:.2f} GiB; "
        f"profiled step: device {dev_ms:.1f} ms of {prof_ms:.1f} ms "
        f"wall, device busy {dev_ms / prof_ms:.4f}; one layer's attention "
        f"forward {att['forward_ms']:.1f} ms, forward + backward "
        f"{att['forward_backward_ms']:.1f} ms: {cfg.num_layers} layers' "
        f"share of a step {res['attention_share_of_step']:.4f}")
    return res


def train_check_readings(dev, row, seed, fault=None, cpu=None, cfg=None):
    """One train step of a CHECK_LAYERS-layer full-width model from one
    seeded state, on the card (with ``fault`` planted: "detach" cuts the
    attention output from its inputs, "nomask" drops the segment mask)
    and on the CPU (``cpu``: a result of an earlier call to reuse).
    Returns (readings, the CPU's result).  ``cfg`` defaults to the
    check's model."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config(SERVE_ARCH).replace(num_layers=CHECK_LAYERS)
    return step_readings(dev, cfg, TRAIN_LR, row, seed, fault, cpu)


def step_readings(dev, cfg, lr, row, seed, fault=None, cpu=None):
    """One train step of ``cfg`` on ``row`` from a state seeded by
    ``seed`` on the card, with ``fault`` planted (``planted``), and on
    the CPU (``cpu``: a result of an earlier call to reuse): |d loss|,
    |d grad_norm| / grad_norm and, per leaf, |d update| / |update|
    (update = new - old parameters), its largest over the leaves; a
    NaN reading (a NaN gradient) reads inf.  Returns (readings, the
    CPU's result)."""
    from repro_torch.models.params import tree_flatten, tree_map
    from repro_torch.train import OptConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    opt = OptConfig(lr=lr, warmup_steps=0, total_steps=10)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(cfg, opt, gen)
    # from step 3 with seeded moments (m ~ N(0, 1e-5), v = m'^2): zero
    # moments make the first update sign(g), and lr is 0 at step 0
    state["step"].fill_(3)
    with torch.no_grad():
        for m in tree_flatten(state["opt"]["m"])[0]:
            m.normal_(0.0, 1e-5, generator=gen)
        for v in tree_flatten(state["opt"]["v"])[0]:
            v.normal_(0.0, 1e-5, generator=gen).square_()
    flat, struct = tree_flatten(state["params"])
    names = list(_leaf_names(struct))
    host = dict(device="cpu", dtype=torch.float32, copy=True)
    before = [x.to(**host) for x in flat]
    del flat
    if cpu is None:
        cpu_state = tree_map(lambda x: x.to("cpu", copy=True), state)
    step = make_train_step(cfg, opt)
    with planted(fault):
        new, cm = step(state, row)
    card = [x.to(**host) for x in tree_flatten(new["params"])[0]]
    card_m = {k: float(v) for k, v in cm.items()}
    del new, state
    if cpu is None:
        crow = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in row.items()}
        new, pm = step(cpu_state, crow)
        cpu = {"params": [x.to(**host)
                          for x in tree_flatten(new["params"])[0]],
               "metrics": {k: float(v) for k, v in pm.items()}}
        del new, cpu_state

    def far(x):
        return float(x) if np.isfinite(x) else float("inf")
    upd = {}
    for name, b, c, p in zip(names, before, card, cpu["params"]):
        want = p - b
        upd[name] = far(float(torch.linalg.vector_norm(c - p)
                              / torch.linalg.vector_norm(want).clamp(
                                  min=1e-30)))
    worst = max(upd, key=upd.get)
    pm = cpu["metrics"]
    return ({"loss": far(abs(card_m["loss"] - pm["loss"])),
             "grad_norm": far(abs(card_m["grad_norm"] - pm["grad_norm"])
                              / pm["grad_norm"]),
             "update": upd[worst], "update_leaf": worst,
             "card_loss": card_m["loss"], "cpu_loss": pm["loss"],
             "card_grad_norm": card_m["grad_norm"],
             "cpu_grad_norm": pm["grad_norm"], "update_by_leaf": upd},
            cpu)


def train_cross_check(dev, row, cfg=None):
    """One step on the card against the CPU from the same state
    (TRAIN_CHECK_TOL)."""
    t0 = time.perf_counter()
    r, _ = train_check_readings(dev, row, TRAIN_SEED + 1, cfg=cfg)
    r["seconds"] = time.perf_counter() - t0
    bad = [k for k, tol in TRAIN_CHECK_TOL.items() if not r[k] <= tol]
    log(f"train cross-check ({CHECK_LAYERS} layer, {CHECK_SEQ} tokens, "
        f"{int(row['segment_ids'].max())} documents): |d loss| "
        f"{r['loss']:.4g} (card {r['card_loss']:.5f}, CPU "
        f"{r['cpu_loss']:.5f}), |d grad_norm| / grad_norm "
        f"{r['grad_norm']:.4g}, worst |d update| / |update| {r['update']:.4g}"
        f" ({r['update_leaf']}); limits {TRAIN_CHECK_TOL}; "
        f"{r['seconds']:.1f} s")
    if bad:
        raise AssertionError(f"train cross-check: {bad} beyond "
                             f"{TRAIN_CHECK_TOL}: {r}")
    return r


# ---------------------------------------------------------------------------
# phases 10-12: serving the moe, ssm and vlm families whole
# ---------------------------------------------------------------------------

# phase: the arch at full width and depth (float32 parameters, as their
# configs say; seeded), its traffic (requests, new tokens, prompt lengths
# a multiple of `multiple` in 256-1,536), and the CPU cross-check: the
# layers it runs (the card runs the same cut) and its prompts.  The
# attention families' checks are cut to 2 layers: at internvl2's full
# depth the random-init model's near one-hot attention (repro's init
# rule) turns bf16 rounding into logits as far from the CPU's as a
# planted fault's (scripts/family_serve_spread.py: rms/std 1.0-1.26
# sound, 1.33-1.47 faulty).  mamba2 is checked whole, at the lengths it
# serves (whole chunks of 256), 512 crossing a chunk boundary
FAMILY_SERVE = {
    "moe": {"phase": 10, "arch": "olmoe-1b-7b", "params": 6_919_096_320,
            "requests": 12, "new": 32, "multiple": 1, "check_layers": 2,
            "check_prompts": CHECK_PROMPTS},
    "ssm": {"phase": 11, "arch": "mamba2-130m", "params": 128_940_480,
            "requests": 12, "new": 32, "multiple": 256, "check_layers": 24,
            "check_prompts": (256, 512)},
    "vlm": {"phase": 12, "arch": "internvl2-2b", "params": 1_699_598_336,
            "requests": 4, "new": 16, "multiple": 1, "check_layers": 2,
            "check_prompts": CHECK_PROMPTS},
    # prompts up to whisper's published text context of 448 tokens; the
    # check cuts the encoder and the decoder to 2 layers each (the CPU
    # runs the encoder over 1,536 frames per prompt)
    "encdec": {"phase": 13, "arch": "whisper-medium", "params": 758_344_704,
               "requests": 8, "new": 32, "multiple": 1, "check_layers": 2,
               "check_prompts": CHECK_PROMPTS, "prompt_len": (32, 448),
               "max_len": 512},
}
# Card against CPU (cross_check_readings: max|d|/std, rms/std and greedy
# gap/std per prompt and step).  scripts/family_serve_spread.py measured
# each family's check config on the card (3 trials of prompts, sound, and
# with two faults planted on the card; NVIDIA H100 80GB HBM3, 700 W): the
# worst sound reading, then the least of each faulty trial's largest:
#   moe  max 0.2648 | renorm 0.3949, overflow 0.4607;  rms 0.0591 |
#        0.0942, 0.0995;  gap 0.1162 | 0.0164, 0.0195 (not separable);
#   ssm  max 0.4839 | chunkstate 0.3459 (not separable here: the carried
#        state has decayed by the checked positions; the continuation
#        check below catches it), convcache 6.2954;  rms 0.1017 | 0.0726,
#        1.3613;  gap 0.3149 | 0.0000, 4.8451;
#   vlm  max 0.2790 | heads 6.3092, len 6.9893;  rms 0.0624 | 1.3536,
#        1.4223;  gap 0.1208 | 5.0751, 5.8409;
#   encdec (2 + 2 layers, random frames) max 3.7292 | enccausal 5.9348,
#        xkv 5.9814;  rms 0.9116 | 1.2588, 1.2912;  gap 3.0415 | 4.5058,
#        4.5919 (whisper's attention is near one-hot at this init, as
#        deepseek's is, so the sound spread is wide).
# Each limit lies between the sound and the faulty readings where they
# separate; the moe gap limit only bounds a gross failure.
FAMILY_TOL = {"moe": {"max": 0.33, "rms": 0.077, "greedy_gap": 1.0},
              "ssm": {"max": 3.0, "rms": 0.7, "greedy_gap": 2.5},
              "vlm": {"max": 3.0, "rms": 0.7, "greedy_gap": 2.5},
              "encdec": {"max": 4.8, "rms": 1.08, "greedy_gap": 3.8}}
# recurrent decode against the chunked apply (float32, phase 11): the
# largest max |d logit| / std over the decoded positions; the spread
# script read 0.0002959 sound, 5.349 with the state not carried across
# chunks and 5.747 with zero conv tails
SSM_CONTINUE_TOL = 1e-2
SSM_CONTINUE = (256, 512)      # prefill 256, decode to 512; prefill 512
# leaves the models use in float32; every other leaf is cast to the
# activation dtype at each use
F32_LEAVES = ("router", "dt_bias", "A_log", "D")


def host_threads(tag) -> dict:
    """The Python threads alive in this process and torch's intra-op
    thread count, logged: the serving phases are host-bound, and a thread
    left running by an earlier phase competes for the interpreter."""
    names = sorted(t.name for t in threading.enumerate())
    log(f"{tag}: {len(names)} Python threads alive ({', '.join(names)}); "
        f"torch intra-op threads {torch.get_num_threads()}")
    return {"python_threads": names, "torch_threads": torch.get_num_threads()}


def family_model(fam, dev):
    """The phase's config and its seeded parameters on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    spec = FAMILY_SERVE[fam]
    cfg = get_config(spec["arch"])
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SERVE_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = api.param_count(cfg)
    if n != spec["params"]:
        raise AssertionError(f"{spec['arch']}: {n:,} parameters, not "
                             f"{spec['params']:,}")
    log(f"serve {fam}: {spec['arch']} whole, {cfg.num_layers} layers at "
        f"full width, {n:,} parameters ({cfg.param_dtype}) drawn in "
        f"{init_s:.3f} s")
    return cfg, params, init_s


def depth_cut(cfg, params, layers):
    """The first ``layers`` layers (views) and the embedding; encdec's
    encoder is cut to as many layers as its decoder."""
    from repro_torch.models.params import tree_map
    if layers == cfg.num_layers:
        return cfg, params
    cut = dict(params, layers=tree_map(lambda x: x[:layers],
                                       params["layers"]))
    if cfg.family == "encdec":
        cut["enc_layers"] = tree_map(lambda x: x[:layers],
                                     params["enc_layers"])
        return cfg.replace(num_layers=layers, encoder_layers=layers), cut
    return cfg.replace(num_layers=layers), cut


def cpu_copy(params, dtype):
    """The CPU's copy of card parameters: every leaf the model casts to
    the activation ``dtype`` at each use is cast once here (the same
    values; the CPU then skips re-casting float32 weights at every
    forward), F32_LEAVES stay as they are."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in F32_LEAVES:
            return tree.cpu()
        return tree.to(dtype).cpu()
    return walk(params)


@contextlib.contextmanager
def moe_drop_tally():
    """Counts the routed (token, expert) pairs of every MoE call and, on
    the device, those kept within capacity, split into prefill groups
    (more tokens than slots) and decode groups."""
    from repro_torch.models import moe as M
    orig = M.expert_slots
    tally = {"prefill": [0, []], "decode": [0, []]}

    def counted(idx, e, cap):
        order, keep, slot = orig(idx, e, cap)
        part = tally["prefill" if idx.shape[1] > SERVE_SLOTS else "decode"]
        part[0] += keep.numel()
        kept = keep.sum()
        part[1].append(kept.full_tensor() if hasattr(kept, "full_tensor")
                       else kept)
        return order, keep, slot
    M.expert_slots = counted
    try:
        yield tally
    finally:
        M.expert_slots = orig


def drop_shares(tally) -> dict:
    out = {}
    for part, (pairs, kept) in tally.items():
        k = int(torch.stack(kept).sum()) if kept else 0
        out[part] = {"pairs": pairs, "dropped": pairs - k,
                     "share": (pairs - k) / pairs if pairs else 0.0}
    pairs = sum(v["pairs"] for v in out.values())
    dropped = sum(v["dropped"] for v in out.values())
    out["all"] = {"pairs": pairs, "dropped": dropped,
                  "share": dropped / pairs if pairs else 0.0}
    return out


def router_agreement(cfg, params, dev, prompts, seed):
    """Each MoE layer's input of the card's prefill of ``prompts`` (drawn
    as cross_check_readings draws them): the experts chosen from it on
    the card and on the CPU (the same input and router, copied).
    Returns the share of (token, slot) choices that are equal."""
    from repro_torch.models import api
    from repro_torch.models import moe as M
    rng = np.random.default_rng(seed)
    seen, orig = [], M.moe_ffn

    def capture(cfg_, p, x):
        seen.append((p["router"], x))
        return orig(cfg_, p, x)
    M.moe_ffn = capture
    try:
        for plen in prompts:
            prompt = rng.integers(16, cfg.vocab_size, (1, plen)).astype(
                np.int32)
            api.prefill(cfg, params, t(prompt, dev))
    finally:
        M.moe_ffn = orig
    equal = total = 0
    for router, x in seen:
        _, card = M._route(torch.matmul(x.float(), router),
                           cfg.experts_per_token)
        _, cpu = M._route(torch.matmul(x.cpu().float(), router.cpu()),
                          cfg.experts_per_token)
        equal += int((card.cpu() == cpu).sum())
        total += cpu.numel()
    return {"layers_seen": len(seen), "choices": total, "equal": equal,
            "share": equal / total}


def family_cross_check(fam, cfg, params, dev, seed=SERVE_SEED + 2):
    """The phase's check config on the card and on the CPU
    (cross_check_readings), the rows and their worst readings."""
    from repro_torch.models.params import torch_dtype
    spec = FAMILY_SERVE[fam]
    ccfg, cparams = depth_cut(cfg, params, spec["check_layers"])
    cpu_params = cpu_copy(cparams, torch_dtype(cfg.dtype))
    rows = cross_check_readings(ccfg, cparams, cpu_params, dev,
                                spec["check_prompts"], seed)
    worst = {k: max(r[k] for r in rows) for k in ("max", "rms",
                                                  "greedy_gap")}
    return ccfg, cparams, rows, worst


def ssm_continuation(cfg, params, dev):
    """Recurrent decode continues the chunked prefill (the invariant of
    tests/test_arch_smoke.py's SSD test) at the published chunk of 256,
    in float32: a prefill of SSM_CONTINUE[0] tokens, then decode steps to
    SSM_CONTINUE[1], each step's logits against the chunked ``apply`` of
    all SSM_CONTINUE[1] tokens at the same position (so the positions
    just past the chunk boundary, which hold the carried state and conv
    tails, count).  Returns the largest max |d logit| / std."""
    from repro_torch.models import api
    cfg32 = cfg.replace(dtype="float32")
    a, b = SSM_CONTINUE
    tok = torch.randint(16, cfg.vocab_size, (1, b), dtype=torch.int32,
                        device=dev, generator=torch.Generator(
                            device=dev).manual_seed(SERVE_SEED + 4))
    full, _ = api.apply(cfg32, params, {"tokens": tok})
    cache, logits = api.prefill(cfg32, params, tok[:, :a])
    worst = []
    for i in range(a, b + 1):
        ref = full[:, i - 1]
        worst.append((logits - ref).abs().max() / ref.std())
        if i < b:
            logits, cache = api.decode_step(cfg32, params, cache,
                                            tok[:, i:i + 1])
    return float(torch.stack(worst).max())


def family_phase(fam, dev):
    """Phases 10-12: the family's model whole through ServingEngine, from
    launch counts and path stats of 0, then its profile and its CPU
    cross-check.  Returns (measurements, the serving run's launches)."""
    from repro_torch.kernels import (launch_counts, path_stats,
                                     reset_launch_counts, reset_path_stats)
    spec = FAMILY_SERVE[fam]
    tag = f"serve {fam}"
    threads = host_threads(tag)
    cfg, params, init_s = family_model(fam, dev)
    serve_warmup(cfg, params, dev)
    lens = spec.get("prompt_len", SERVE_PROMPT_LEN)
    max_len = spec.get("max_len", SERVE_MAX_LEN)
    reqs = serve_requests(cfg, spec["requests"], spec["new"],
                          spec["multiple"], lens)
    reset_launch_counts()
    reset_path_stats()
    with (moe_drop_tally() if fam == "moe"
          else contextlib.nullcontext()) as tally:
        res = serve_path(cfg, params, dev, reqs, tag=tag, max_len=max_len)
    counts, paths = launch_counts(), path_stats()
    # per admission, prefill runs every attention layer once (encdec:
    # its encoder's, and each decoder layer's self- and cross-attention)
    # and gives the first token; an encdec decode step runs each decoder
    # layer's cross-attention over the cached encoder rows
    attn, per_step = (0 if fam == "ssm" else cfg.num_layers), 0
    if fam == "encdec":
        attn = cfg.encoder_layers + 2 * cfg.num_layers
        per_step = cfg.num_layers
    want = {n: 0 for n in counts}
    want["flash_attention"] = (attn * res["prefills"]
                               + per_step * res["decode_steps"])
    log(f"{tag}: launches {counts} (expected {want}); attention paths "
        f"{paths}")
    if counts != want or paths.get(("flash_attention", "plain_on_card")) \
            or (fam == "ssm" and paths):
        raise AssertionError(f"{tag}: the serving path's launches or "
                             "attention paths are not the expected ones")
    res.update({"arch": spec["arch"], "layers": cfg.num_layers,
                "parameters": spec["params"], "init_s": init_s,
                "host": threads})
    if tally is not None:
        res["moe_drops"] = drop_shares(tally)
        d = res["moe_drops"]
        log(f"{tag}: routed pairs dropped for capacity: prefill "
            f"{d['prefill']['dropped']} of {d['prefill']['pairs']} "
            f"({d['prefill']['share']:.4f}), decode "
            f"{d['decode']['dropped']} of {d['decode']['pairs']}, all "
            f"{d['all']['share']:.4f}")
    res["profile"] = profile_serving(cfg, params, dev, n=lens[1],
                                     flash=attn > 0, tag=tag,
                                     max_len=max_len)
    if fam == "moe":
        # repro casts every expert leaf to bf16 at every call: per decode
        # step each layer reads 4 and writes 2 bytes of each expert weight
        nbytes = (cfg.num_layers * 3 * cfg.num_experts * cfg.d_model
                  * cfg.d_ff * 6)
        floor = nbytes / PEAK_BYTES_S * 1e3
        res["decode_floor"] = {"bytes": nbytes, "ms": floor,
                               "decode_ms_over_floor":
                               res["decode_ms_per_step"] / floor}
        log(f"{tag}: decode {res['decode_ms_per_step']:.2f} ms a step "
            f"against the expert casts' floor {floor:.2f} ms "
            f"({nbytes / 1e9:.1f} GB at {PEAK_BYTES_S / 1e12:.2f} TB/s): "
            f"{res['decode_ms_per_step'] / floor:.2f}x")
    t0 = time.perf_counter()
    ccfg, cparams, rows, worst = family_cross_check(fam, cfg, params, dev)
    tol = FAMILY_TOL[fam]
    bad = [r for r in rows if not all(r[k] <= tol[k] for k in tol)]
    log(f"{tag} cross-check: {ccfg.num_layers} of {cfg.num_layers} layers, "
        f"prompts {spec['check_prompts']} x {CHECK_STEPS} decode steps, "
        f"card vs CPU (teacher-forced): worst max|d|/std "
        f"{worst['max']:.4f}, rms/std {worst['rms']:.4f}, greedy gap/std "
        f"{worst['greedy_gap']:.4f} (limits {tol}); "
        f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"{tag} cross-check beyond {tol}: {bad[:3]}")
    res["cross_check"] = {**worst, "check_layers": ccfg.num_layers,
                          "seconds": time.perf_counter() - t0}
    if fam == "moe":
        ag = router_agreement(ccfg, cparams, dev, spec["check_prompts"],
                              SERVE_SEED + 2)
        res["router_agreement"] = ag
        log(f"{tag}: router agreement card vs CPU on the same layer "
            f"inputs: {ag['equal']} of {ag['choices']} (token, slot) "
            f"choices equal ({ag['share']:.6f}) over {ag['layers_seen']} "
            "layer calls")
    if fam == "ssm":
        d = ssm_continuation(cfg, params, dev)
        res["continuation"] = {"max_over_std": d, "tol": SSM_CONTINUE_TOL,
                               "prefill": SSM_CONTINUE[0],
                               "decoded_to": SSM_CONTINUE[1]}
        log(f"{tag}: float32 recurrent decode from a {SSM_CONTINUE[0]}-"
            f"token prefill to {SSM_CONTINUE[1]} against the chunked apply "
            f"of {SSM_CONTINUE[1]} tokens, position by position: max|d|/std "
            f"{d:.3g} (tol {SSM_CONTINUE_TOL})")
        if not d <= SSM_CONTINUE_TOL:
            raise AssertionError(f"{tag}: recurrent decode does not "
                                 "continue the chunked prefill")
    del params, cparams
    gc.collect()
    torch.cuda.empty_cache()
    return res, counts


# ---------------------------------------------------------------------------
# phase 15: training the moe, ssm, vlm and encdec families on the card
# ---------------------------------------------------------------------------

# phase 15: each family at full width through the Trainer, fed by the LM
# data plane; depth where the whole model's float32 state and its
# activations at the step's tokens fit one card (olmoe whole holds 103 GiB
# of state: 4 of its 16 layers hold 28 GiB).  Rows x tokens: 2 x 4,096
# (internvl2's 4,096 positions are 256 patch rows and 3,840 tokens);
# whisper trains at its published text context of 448 tokens, 8 rows of
# them over 8 x 1,536 frames, at 12 + 12 of its 24 + 24 layers: at the
# whole depth its random-init gradient reaches 2.5e24 (repro's, float32,
# on the CPU; the port's alike), the float32 sum of squares overflows and
# the clipping norm is inf (on the card: inf at every step); at 12 + 12
# the norm is 2.1e16.  internvl2 checkpoints whole layers (remat
# "full", not its config's "dots"): "dots" keeps every score block of the
# plain chunked attention, 24 layers of which at 4,096 positions did not
# fit beside its 25 GiB of state (out of memory on the card).  The
# card-vs-CPU check takes one step of a cut model (check_layers;
# whisper's encoder cut as its decoder) on check_seq positions of one
# packed row, from a seeded state.
FAMILY_TRAIN = {
    "moe": {"arch": "olmoe-1b-7b", "layers": 4, "seq": 4096, "batch": 2,
            "check_layers": 1, "check_seq": 512},
    "ssm": {"arch": "mamba2-130m", "layers": None, "seq": 4096, "batch": 2,
            "check_layers": 24, "check_seq": 512},
    "vlm": {"arch": "internvl2-2b", "layers": None, "seq": 4096, "batch": 2,
            "check_layers": 1, "check_seq": 512, "remat": "full"},
    "encdec": {"arch": "whisper-medium", "layers": 12, "seq": 448,
               "batch": 8, "check_layers": 1, "check_seq": 448},
}
FAMILY_TRAIN_WARM, FAMILY_TRAIN_TIMED = 1, 4
FAMILY_TRAIN_LR = 3e-4
# faults the spread script plants on the card (scripts/family_train_spread
# .py): moe the experts' output or the router's weights detached; ssm
# repro's mask after the exp (NaN gradients at chunk 256) or the SSD's B
# input detached; vlm the attention output detached or the segment mask
# dropped (as phase 9); encdec the cross-attention detached or a causal
# encoder
FAMILY_TRAIN_FAULTS = {"moe": ("expert_detach", "router_detach"),
                       "ssm": ("mask_after_exp", "b_detach"),
                       "vlm": ("detach", "nomask"),
                       "encdec": ("cross_detach", "enc_causal")}
# Card against CPU after one step from the same state: |d loss|, |d
# grad_norm| / grad_norm, and the worst leaf's |d update| / |update|.
# scripts/family_train_spread.py measured them (3 trials; NVIDIA H100
# 80GB HBM3, 700 W): the worst sound reading | each fault's least:
#   moe     loss 3.91e-5 | not separable (the faults cut gradients, not
#           the forward); grad_norm 1.16e-3 | 9.1e-5, 8.0e-5 (not
#           separable); update 0.375 | expert_detach 0.801,
#           router_detach 0.801;
#   ssm     loss 7.68e-4 | not separable; grad_norm 0.0300 |
#           mask_after_exp inf (NaN), b_detach 0.380; update 1.512 |
#           inf, 8.968;
#   vlm     loss 1.66e-4 | nomask 6.2e-4; grad_norm 0.00713 | detach
#           0.885, nomask 0.201; update 0.583 | 31.3, 1.148;
#   encdec  loss 3.81e-4 | enc_causal 0.00782; grad_norm 0.0400 |
#           cross_detach 0.882, enc_causal 0.031; update 1.546 | 25.0,
#           2.430.
# Each limit lies between where they separate; where they do not, it
# only bounds a gross failure.  Every faulty trial passes a limit.
FAMILY_TRAIN_TOL = {
    "moe": {"loss": 0.005, "grad_norm": 0.05, "update": 0.6},
    "ssm": {"loss": 0.005, "grad_norm": 0.2, "update": 5.0},
    "vlm": {"loss": 0.005, "grad_norm": 0.1, "update": 0.9},
    "encdec": {"loss": 0.004, "grad_norm": 0.1, "update": 2.0},
}


def family_train_cfg(fam, layers=None):
    """The phase's config, cut to ``layers`` (encdec: both stacks)."""
    from repro_torch.configs import get_config
    spec = FAMILY_TRAIN[fam]
    cfg = get_config(spec["arch"]).replace(
        remat=spec.get("remat", get_config(spec["arch"]).remat))
    n = layers or spec["layers"]
    if n is None:
        return cfg
    if cfg.family == "encdec":
        return cfg.replace(num_layers=n, encoder_layers=n)
    return cfg.replace(num_layers=n)


def family_train_flops(cfg, seq: int, batch: int) -> float:
    """Model FLOPs of one training step (forward and backward: 3 x the
    forward's 2 per multiply-add).  Weights: 6 x the parameters a position
    uses, per position: every parameter, except that an MoE token uses
    the router and its k of E experts.  Attention, per position: causal
    self-attention 6 * L * H * D * S (S/2 keys on average); the SSM has
    none; encdec's encoder attends to all F frames non-causally (12 * L *
    H * D * F per frame), its decoder causally to its tokens and to all
    F frames (12 * L * H * D * F per token), and its encoder's weights
    run once per frame.  ``seq`` counts a vlm's patch rows."""
    from repro_torch.models import api
    from repro_torch.models.params import tree_flatten
    h, d = cfg.num_heads, cfg.resolved_head_dim
    if cfg.family == "encdec":
        params = api.param_shapes(cfg)
        enc = sum(x.numel() for x in tree_flatten(params["enc_layers"])[0])
        dec = api.param_count(cfg) - enc
        f = cfg.num_frontend_tokens
        per_row = (f * (6.0 * enc + 12.0 * cfg.encoder_layers * h * d * f)
                   + seq * (6.0 * dec + 6.0 * cfg.num_layers * h * d * seq
                            + 12.0 * cfg.num_layers * h * d * f))
        return batch * per_row
    n = api.param_count(cfg)
    if cfg.num_experts:
        n -= (cfg.num_experts - cfg.experts_per_token) * 3 * cfg.d_model \
            * cfg.d_ff * cfg.num_layers
    attn = 0.0 if cfg.family == "ssm" else \
        6.0 * cfg.num_layers * h * d * seq
    return batch * seq * (6.0 * n + attn)


def with_frontend(cfg, batches, dev, seed=SERVE_SEED + 3):
    """The vlm's patch rows and the encdec's frames with each packed
    batch: seeded N(0, 1) rows drawn once on ``dev``.  Not the serving
    phases' zeros: zero rows stay exactly zero through every layer, so
    each rmsnorm's Jacobian at zero (1 / sqrt(eps) = 1,000) multiplies
    the gradient that reaches them once a layer, and at 24 layers it
    overflows (whisper's first step on the card: NaN; repro's gradient
    overflows alike)."""
    if cfg.family not in ("vlm", "encdec"):
        yield from batches
        return
    fe = None
    for b in batches:
        if fe is None:
            shape = (b["tokens"].shape[0], cfg.num_frontend_tokens,
                     cfg.d_model)
            fe = torch.randn(shape, generator=torch.Generator(
                device=dev).manual_seed(seed), device=dev).to(
                    torch.bfloat16)
        yield dict(b, frontend=fe)


@contextlib.contextmanager
def planted(fault):
    """Plant ``fault`` (phase 9's "detach" and "nomask", or one of
    FAMILY_TRAIN_FAULTS) into the model code; None plants nothing."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import ssm as S
    if fault is None:
        yield
        return
    swaps = []
    if fault == "expert_detach":
        orig = M._dispatch_combine
        swaps.append((M, "_dispatch_combine",
                      lambda *a: orig(*a).detach()))
    elif fault == "router_detach":
        orig = M._route
        swaps.append((M, "_route", lambda lg, k: tuple(
            x.detach() for x in orig(lg, k))))
    elif fault == "mask_after_exp":
        swaps.append((S, "_decay", lambda diff, tri: torch.where(
            tri, torch.exp(diff), 0.0)))
    elif fault == "b_detach":
        orig = S.ssd_chunked
        swaps.append((S, "ssd_chunked", lambda cfg, xh, dt, b, c, *a:
                      orig(cfg, xh, dt, b.detach(), c, *a)))
    elif fault in ("detach", "nomask"):
        orig = L._sdpa

        def sdpa(cfg_, q, k, v, pq, pk, sq, sk, causal):
            if fault == "nomask":
                sq = sk = None
            out = orig(cfg_, q, k, v, pq, pk, sq, sk, causal)
            return out.detach() if fault == "detach" else out
        swaps.append((L, "_sdpa", sdpa))
    elif fault == "cross_detach":
        orig = L.cross_attention

        def cross(*a):
            out, kv = orig(*a)
            return out.detach(), kv
        swaps.append((L, "cross_attention", cross))
    elif fault == "enc_causal":
        orig = L.attention
        swaps.append((L, "attention", lambda *a, causal=True: orig(
            *a, causal=True)))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, fn in swaps:
            setattr(m, n, fn)
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def family_check_row(fam, store, dev, cfg, seed=0):
    """The check's batch: the first row of a batch of the family's LM data
    plane, cut to check_seq positions (a vlm's token run after its patch
    rows), with seeded frontend rows for vlm and encdec."""
    from repro_torch.models import api
    spec = FAMILY_TRAIN[fam]
    n = api.token_len(cfg, spec["check_seq"])
    src = train_source(store, dev, cfg, seq=n, batch=1, frames=1)
    try:
        it = iter(src)
        for _ in range(seed):
            next(it)
        row = next(it)
    finally:
        src.close()
    return next(with_frontend(cfg, [row], dev, seed=SERVE_SEED + 3 + seed))


def family_step_readings(fam, dev, row, seed, fault=None, cpu=None):
    """``step_readings`` of the family's check model (FAMILY_TRAIN's
    check_layers at full width)."""
    cfg = family_train_cfg(fam, FAMILY_TRAIN[fam]["check_layers"])
    r, cpu = step_readings(dev, cfg, FAMILY_TRAIN_LR, row, seed, fault, cpu)
    r.pop("update_by_leaf")
    r["check_layers"] = cfg.num_layers
    return r, cpu


def family_train(fam, dev, store, check=True):
    """Phase 15 for one family: the Trainer over the LM data plane from
    counts and path stats of 0; every loss and gradient norm finite, the
    exact step count, no kernel launched and every training attention
    the plain chunked version on the card; tokens/s, the step split,
    peak memory and train_mfu; then, unless ``check`` is False, the
    card-vs-CPU check.  Returns (measurements, the run's launches)."""
    from repro_torch.kernels import (launch_counts, path_stats,
                                     reset_launch_counts, reset_path_stats)
    from repro_torch.models import api
    from repro_torch.train import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    spec = FAMILY_TRAIN[fam]
    tag = f"train {fam}"
    cfg = family_train_cfg(fam)
    steps = FAMILY_TRAIN_WARM + FAMILY_TRAIN_TIMED
    opt = OptConfig(lr=FAMILY_TRAIN_LR, warmup_steps=FAMILY_TRAIN_WARM,
                    total_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, opt, TrainerConfig(steps=steps, log_every=1,
                                              seed=TRAIN_SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.param_count(cfg)
    toks = api.token_len(cfg, spec["seq"])
    log(f"{tag}: {spec['arch']} at full width, {cfg.num_layers} layers"
        f"{'' if spec['layers'] is None else ' (cut)'}, {n_params:,} "
        f"parameters ({cfg.param_dtype}, activations {cfg.dtype}), remat "
        f"{cfg.remat}: drawn in {init_s:.3f} s")
    source = train_source(store, dev, cfg, seq=toks, batch=spec["batch"])
    reset_launch_counts()
    reset_path_stats()
    try:
        t0 = time.perf_counter()
        hist = trainer.run(with_frontend(cfg, iter(source), dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        source.close()
    counts, paths = launch_counts(), path_stats()
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if (int(trainer.state["step"]) != steps or len(hist) != steps
            or not all(np.isfinite(losses + norms))):
        raise AssertionError(f"{tag}: {int(trainer.state['step'])} steps "
                             f"of {steps}, losses {losses}, gradient norms "
                             f"{norms}")
    # the plain version on the card ("reference" in a CPU rehearsal)
    plain = ("flash_attention",
             "plain_on_card" if dev.type == "cuda" else "reference")
    if any(counts.values()) or any(p != plain for p in paths) \
            or (fam == "ssm") != (not paths):
        raise AssertionError(f"{tag}: launches {counts} or attention paths "
                             f"{paths}: training takes no kernel, and every "
                             "attention is the plain chunked version")
    timed = trainer.step_times[FAMILY_TRAIN_WARM:]
    step_s = [t["data_wait_s"] + t["grad_s"] + t["update_s"] for t in timed]
    med = float(statistics.median(step_s))
    timed_wall = hist[-1]["wall_s"] - hist[FAMILY_TRAIN_WARM - 1]["wall_s"]
    flops = family_train_flops(cfg, spec["seq"], spec["batch"])
    res = {"arch": spec["arch"], "layers": cfg.num_layers,
           "parameters": n_params, "seq": spec["seq"], "tokens": toks,
           "batch": spec["batch"], "steps": steps, "init_s": init_s,
           "wall_s": wall, "losses": losses, "grad_norms": norms,
           "launches": counts,
           "paths": {f"{a}/{b}": n for (a, b), n in paths.items()},
           "step_ms_median": med * 1e3,
           "data_wait_ms_median": statistics.median(
               t["data_wait_s"] for t in timed) * 1e3,
           "forward_backward_ms_median": statistics.median(
               t["grad_s"] for t in timed) * 1e3,
           "optimizer_ms_median": statistics.median(
               t["update_s"] for t in timed) * 1e3,
           "tokens_per_s": FAMILY_TRAIN_TIMED * spec["batch"] * toks
           / timed_wall,
           "model_flops_per_step": flops,
           "train_mfu": flops / med / PEAK_BF16_S,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    extra = spec["seq"] - toks
    log(f"{tag}: {steps} steps ({FAMILY_TRAIN_WARM} warm) of "
        f"{spec['batch']} x {toks} tokens"
        f"{f' (after {extra} patch rows)' if extra else ''}"
        f" in {wall:.2f} s: {res['tokens_per_s']:.1f} tokens/s; step "
        f"{med * 1e3:.1f} ms (median) = data wait "
        f"{res['data_wait_ms_median']:.2f} + forward + backward "
        f"{res['forward_backward_ms_median']:.1f} + optimizer "
        f"{res['optimizer_ms_median']:.1f}; peak memory "
        f"{res['peak_memory_bytes'] / 2**30:.2f} GiB; train_mfu "
        f"{res['train_mfu']:.4f} ({flops / 1e12:.2f} TFLOP a step over "
        f"{PEAK_BF16_S / 1e12:.0f} TFLOP/s bf16); losses "
        + ", ".join(f"{x:.4f}" for x in losses))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if not check:
        return res, counts
    t0 = time.perf_counter()
    row = family_check_row(fam, store, dev, family_train_cfg(
        fam, spec["check_layers"]))
    r, _ = family_step_readings(fam, dev, row, TRAIN_SEED + 1)
    r["seconds"] = time.perf_counter() - t0
    tol = FAMILY_TRAIN_TOL[fam]
    log(f"{tag} cross-check ({r['check_layers']} layer(s), "
        f"{spec['check_seq']} positions): |d loss| {r['loss']:.4g} (card "
        f"{r['card_loss']:.5f}, CPU {r['cpu_loss']:.5f}), |d grad_norm| / "
        f"grad_norm {r['grad_norm']:.4g}, worst |d update| / |update| "
        f"{r['update']:.4g} ({r['update_leaf']}); limits {tol}; "
        f"{r['seconds']:.1f} s")
    if not all(r[k] <= v for k, v in tol.items()):
        raise AssertionError(f"{tag} cross-check beyond {tol}: {r}")
    res["cross_check"] = r
    gc.collect()
    torch.cuda.empty_cache()
    return res, counts


def check_q5_under_tf32(dev, store):
    """Q5 over one batch with TF32 on, as the training phases run:
    ``nearby_facility_counts`` (every column) equal to the CPU's, and
    the card's d2 of the batch against the facilities (the cross term
    without cuBLAS) against the CPU's, bit for bit or not."""
    from repro_torch.core import ComputingRunner, ComputingSpec
    from repro_torch.core.enrich import ops
    from repro_torch.core.enrich import queries as Q
    from repro_torch.core.records import SyntheticTweets, parse_json_lines
    batch = parse_json_lines(SyntheticTweets(seed=SEED_STREAM).raw_lines(
        BATCH))
    assert torch.backends.cuda.matmul.allow_tf32
    got = ComputingRunner(ComputingSpec(Q.Q5, BATCH), store,
                          device=dev).run(dict(batch))
    want = ComputingRunner(ComputingSpec(Q.Q5, BATCH), store,
                           device="cpu").run(dict(batch))
    for key in want:
        if not np.array_equal(np.asarray(got[key]), np.asarray(want[key])):
            raise AssertionError(f"Q5 under TF32: {key} differs from the "
                                 "CPU's")
    a = store["facilities"].snapshot().arrays
    pts = torch.from_numpy(np.stack([batch["lat"], batch["lon"]], 1)[:512])
    refs = torch.from_numpy(np.stack([a["lat"], a["lon"]], 1))
    d_card = ops.pairwise_dist2(pts.to(dev), refs.to(dev)).cpu()
    d_cpu = ops.pairwise_dist2(pts, refs)
    res = {"rows": int(np.asarray(want["nearby_facility_counts"]).shape[0]),
           "counts_equal": True,
           "d2_bit_equal_share": float((d_card == d_cpu).float().mean()),
           "d2_max_abs_diff": float((d_card - d_cpu).abs().max())}
    log(f"Q5 with TF32 on: {res['rows']} rows, every column equal to the "
        f"CPU's; d2 of 512 tweets x {refs.shape[0]:,} facilities bit-equal "
        f"to the CPU's in a share of {res['d2_bit_equal_share']:.6f} (max "
        f"|d| {res['d2_max_abs_diff']:.3g})")
    return res


# ---------------------------------------------------------------------------
# phase 16: the distributed modules on the card at world size 1
# ---------------------------------------------------------------------------

MOE_EP_TOL = {"rtol": 2e-4, "atol": 2e-5}    # tests/test_moe_ep.py's
MOE_EP_LOSS_RTOL = 1e-4


def distributed_phase(dev, out_dir):
    """Phase 16: an NCCL group of one rank (a file store: no port), a
    (1, 1) mesh, and on it moe_ffn_ep against moe_ffn at olmoe's full
    width (capacity 8.0: no pair drops), a 2-layer olmoe's loss with
    moe_ep on and off, one Trainer step with moe_ep at the config's
    capacity on the production layout, its loss and gradient norm
    bit-equal to the plain Trainer's step (the EP body on the mesh's
    model axis of one rank, as its moe_ep layers run on plain tensors
    under the mesh), psum_compressed against decompress(compress(g)),
    and a save -> restore(shardings=remesh_shardings(...)) round trip,
    bit-equal."""
    import torch.distributed as dist
    from repro_torch.ckpt import restore, save
    from repro_torch.models import api
    from repro_torch.models import moe as M
    from repro_torch.models import moe_ep as MEP
    from repro_torch.models.params import init_tree, tree_flatten
    from repro_torch.models.sharding import DEFAULT_RULES, sharding_ctx
    from repro_torch.runtime.elastic import build_mesh, remesh_shardings
    from repro_torch.train import OptConfig
    from repro_torch.train import compression as C
    from repro_torch.train.steps import train_state_axes, train_state_shapes
    from repro_torch.train.trainer import Trainer, TrainerConfig
    root = os.path.abspath(os.path.join(out_dir, "distributed"))
    os.makedirs(root, exist_ok=True)
    store_path = os.path.join(root, "pg")
    if os.path.exists(store_path):
        os.remove(store_path)
    res = {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store_path}", rank=0,
                            world_size=1)
    try:
        mesh = build_mesh(model_parallel=1, device=dev)
        # (a) the EP layer against moe_ffn, float32 (both route on the
        # same float32 logits)
        cfg = family_train_cfg("moe").replace(
            capacity_factor=8.0, dtype="float32", moe_ep=True)
        gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
        p = init_tree(M.moe_specs(cfg), gen, "float32")
        x = torch.randn((2, 1024, cfg.d_model), generator=gen,
                        device=dev) * 0.3
        y0, a0 = M.moe_ffn(cfg, p, x)
        with sharding_ctx(mesh):
            y1, a1 = MEP.moe_ffn_ep(cfg, p, x)
        err = float((y1 - y0).abs().max())
        ok = bool(torch.allclose(y1, y0, **MOE_EP_TOL))
        res["moe_ffn_ep"] = {"max_abs_err": err, "y_scale": float(
            y0.abs().max()), "aux": float(a1), "aux_moe_ffn": float(a0),
            "tol": MOE_EP_TOL, "shape": list(x.shape)}
        log(f"distributed: moe_ffn_ep vs moe_ffn at olmoe's width "
            f"({cfg.num_experts} experts, {cfg.experts_per_token} a token, "
            f"capacity 8.0, x {tuple(x.shape)} float32): max |d y| {err:.3g}"
            f" of max |y| {res['moe_ffn_ep']['y_scale']:.3g}; aux "
            f"{float(a1):.6f} vs {float(a0):.6f}")
        if not ok or not abs(float(a1) - float(a0)) <= 1e-5 * float(a0):
            raise AssertionError(f"moe_ffn_ep differs from moe_ffn: "
                                 f"{res['moe_ffn_ep']}")
        del p, x, y0, y1
        # (b) a 2-layer olmoe's loss, moe_ep on and off
        cfg2 = family_train_cfg("moe", 2).replace(
            capacity_factor=8.0, dtype="float32", moe_ep=True)
        params = api.init_params(cfg2, torch.Generator(
            device=dev).manual_seed(SERVE_SEED))
        row = packed_row(512, seed=3, vocab=cfg2.vocab_size)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in row.items()}
        with torch.no_grad(), sharding_ctx(mesh):
            l_ep, _ = api.loss(cfg2, params, batch)
        with torch.no_grad():
            l_ref, _ = api.loss(cfg2.replace(moe_ep=False), params, batch)
        rel = abs(float(l_ep) - float(l_ref)) / abs(float(l_ref))
        res["loss_2_layers"] = {"moe_ep": float(l_ep),
                                "moe_ffn": float(l_ref), "rel": rel,
                                "rtol": MOE_EP_LOSS_RTOL}
        log(f"distributed: 2-layer olmoe loss with moe_ep {float(l_ep):.6f}"
            f", without {float(l_ref):.6f} (rel {rel:.3g}, rtol "
            f"{MOE_EP_LOSS_RTOL})")
        if not rel <= MOE_EP_LOSS_RTOL:
            raise AssertionError("the moe_ep loss differs")
        del params
        # (c) one Trainer step with moe_ep at the config's capacity on the
        # production layout of the mesh, and the plain Trainer's on the
        # same seed and batch (its plain tensors are the EP body's own
        # under the mesh)
        cfg3 = family_train_cfg("moe", 2).replace(moe_ep=True)
        opt = OptConfig(lr=FAMILY_TRAIN_LR, warmup_steps=0, total_steps=1)
        b2 = packed_row(4096, seed=4, vocab=cfg3.vocab_size)
        b2 = {k: np.concatenate([v, v]) for k, v in b2.items()}
        steps = {}
        for name, m in (("production", mesh), ("plain", None)):
            t = Trainer(cfg3, opt, TrainerConfig(steps=1, log_every=1,
                                                 seed=TRAIN_SEED),
                        device=dev, mesh=m)
            t0 = time.perf_counter()
            with sharding_ctx(mesh):
                hist = t.run(iter([b2]))
            torch.cuda.synchronize()
            steps[name] = {"loss": hist[-1]["loss"],
                           "grad_norm": hist[-1]["grad_norm"],
                           "seconds": time.perf_counter() - t0,
                           "layout": t.step_fn.layout,
                           "step": int(t.state["step"])}
            if m is None:
                del t
            else:
                trainer = t
        prod, plain = steps["production"], steps["plain"]
        bit = (prod["loss"] == plain["loss"]
               and prod["grad_norm"] == plain["grad_norm"])
        res["trainer_step"] = {**prod, "plain": plain, "bit_equal": bit,
                               "capacity_factor": cfg3.capacity_factor}
        log(f"distributed: one Trainer step on the {prod['layout']} layout "
            f"of the (1, 1) mesh, 2-layer olmoe with moe_ep at capacity "
            f"{cfg3.capacity_factor}, 2 x 4,096 tokens: loss "
            f"{prod['loss']:.6f}, grad_norm {prod['grad_norm']:.6f}, "
            f"{prod['seconds']:.2f} s; the plain Trainer's {plain['loss']:.6f}"
            f", {plain['grad_norm']:.6f}, {plain['seconds']:.2f} s: "
            f"bit-equal {bit}")
        if (prod["step"] != 1 or prod["layout"] != "production" or not bit
                or not np.isfinite([prod["loss"], prod["grad_norm"]]).all()):
            raise AssertionError(f"the moe_ep Trainer step: {steps}")
        # (d) psum_compressed at world size 1 is decompress(compress(g))
        g = {"a": torch.randn(3, 1000, generator=gen, device=dev),
             "b": torch.randn(17, 5, generator=gen, device=dev)}
        e = {k: torch.randn(v.shape, generator=gen, device=dev) * 1e-3
             for k, v in g.items()}
        mean, err1 = C.psum_compressed(g, e)
        comp, err2 = C.compress_tree(g, e)
        deq = C.decompress_tree(comp, g)
        same = all(torch.equal(mean[k], deq[k]) and torch.equal(err1[k],
                                                                err2[k])
                   for k in g)
        res["psum_compressed_bit_equal"] = same
        log(f"distributed: psum_compressed over 1 rank equals "
            f"decompress(compress(g)) and its error bit for bit: {same}")
        if not same:
            raise AssertionError("psum_compressed at world size 1")
        # (e) save the trainer's state from the mesh, restore it onto a
        # new (1, 1) mesh's placements
        ck = os.path.join(root, "ckpt")
        save(ck, 1, trainer.state)
        new_mesh = build_mesh(model_parallel=1, device=dev)
        plan = remesh_shardings(train_state_shapes(cfg3, opt),
                                train_state_axes(cfg3, opt), new_mesh,
                                DEFAULT_RULES)
        back = restore(ck, train_state_shapes(cfg3, opt), shardings=plan)
        pairs = list(zip(tree_flatten(back)[0],
                         tree_flatten(trainer.state)[0]))
        equal = all(torch.equal(b.to_local(), s.to_local())
                    for b, s in pairs)
        res["restore_bit_equal"] = equal
        res["restore_leaves"] = len(pairs)
        log(f"distributed: save -> restore(shardings=remesh_shardings(...)) "
            f"of {len(pairs)} leaves onto a new (1, 1) mesh: bit-equal "
            f"{equal}")
        if not equal:
            raise AssertionError("the remesh round trip is not bit-equal")
        del trainer, back
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 17: the launch tooling's dry run, held to the card
# ---------------------------------------------------------------------------

LAUNCH_PREFILL = 1536          # phase 8's longest prompt, one row
LAUNCH_TIMED = 3
# measured peak bytes of phase 9's step (torch.cuda.max_memory_allocated
# above what was allocated before its state) / the dry run's predicted
# argument + temporary + output bytes.  This phase's first run read 1.0014
# (45.347 against 45.282 GiB; torch 2.11.0+cu128, NVIDIA H100 80GB HBM3,
# 700.00 W): the band allows the caching allocator's rounding and
# workspaces, and fails a prediction off by 3 % or more
LAUNCH_MEM_BAND = (0.97, 1.03)
# model FLOPs / (the 256-rank cell's per-device FLOPs x 256).  Each
# weight is placed at its use (models/sharding.py::product_operands): every
# product on the rank's own 8 rows, the contraction split over "model"
# where the weight is whole there (the head: 50,280 does not divide by 16),
# as repro's XLA program does (0.927; the port reads 0.966 at torch
# 2.13.0+cpu, the SSD state update counted beside it).  A rank repeating
# its "model" group's products reads at most 1/16 of that, DTensor's own
# placement read 0.18 (torch 2.11), and a count taken above DTensor
# (1/256) or one that misses matmuls falls outside
LAUNCH_USEFUL_BAND = (0.75, 1.1)
# repro's collective wire bytes a device in the same 256-rank cell
# (scripts/dryrun_side_by_side.py mamba2-130m:decode_32k:single, XLA on
# 256 placeholder devices): the port's may not exceed them.  The port read
# 237,584,640 before a decode step kept its SSM state and scores where
# they lie and moved a weight's FSDP shard onto "model" by a permute, and
# 20,524,800 after (torch 2.13.0+cpu)
LAUNCH_WIRE_REPRO = 35_631_968
LAUNCH_CHILD_TIMEOUT = 600


def phase9_opt():
    from repro_torch.train import OptConfig
    return OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARM,
                     total_steps=TRAIN_WARM + TRAIN_TIMED)


def dryrun_cells() -> dict:
    """Phase 17's dry-run cells: phase 9's training cell and phase 8's
    dense prefill at 1 x 1 on the card's device type, and a production
    cell of 256 fake ranks."""
    from repro_torch.configs.base import ShapeSpec
    cut = {"num_layers": TRAIN_LAYERS}
    return {
        "train": dict(arch=SERVE_ARCH, shape_name="train_4k",
                      multi_pod=False, cfg_overrides=cut,
                      shape=ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH,
                                      "train"),
                      mesh_shape=(1, 1), opt=phase9_opt()),
        "prefill": dict(arch=SERVE_ARCH, shape_name="prefill_32k",
                        multi_pod=False, cfg_overrides=cut,
                        shape=ShapeSpec("prefill_32k", LAUNCH_PREFILL, 1,
                                        "prefill"),
                        mesh_shape=(1, 1)),
        "sharded": dict(arch="mamba2-130m", shape_name="decode_32k",
                        multi_pod=False),
    }


def dryrun_child(name: str, out_dir: str, device: str = "cuda") -> int:
    """(phase 17) one dry-run cell in this interpreter, its artifact
    written to out_dir/dryrun_<name>.json."""
    from repro_torch.launch.dryrun import run_cell
    # phase 9 runs its float32 products in TF32: the roofline prices them
    # at TF32's peak
    torch.backends.cuda.matmul.allow_tf32 = name == "train"
    res = run_cell(**dryrun_cells()[name], device=device)
    with open(os.path.join(out_dir, f"dryrun_{name}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    return 0


def run_dryruns(out_dir: str) -> dict:
    """Phase 17's dry runs, one child interpreter each (a process group
    is process-wide), one after another; a child that fails, or a cell
    whose status is not ok, fails the phase."""
    out = {}
    for name in dryrun_cells():
        log_path = os.path.join(out_dir, f"dryrun_{name}.log")
        with open(log_path, "w") as log_fh:
            rc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--dryrun-child",
                 name, "--out", out_dir], stdout=log_fh,
                stderr=subprocess.STDOUT, cwd=ROOT,
                timeout=LAUNCH_CHILD_TIMEOUT).returncode
        path = os.path.join(out_dir, f"dryrun_{name}.json")
        if rc != 0 or not os.path.exists(path):
            with open(log_path) as fh:
                tail = fh.read()[-3000:]
            raise AssertionError(f"dry run {name} exited {rc}:\n{tail}")
        with open(path) as fh:
            out[name] = json.load(fh)
        if out[name]["status"] != "ok":
            raise AssertionError(f"dry run {name}: {out[name]['status']} "
                                 f"{out[name].get('error', '')[:2000]}")
    return out


def tree_bytes(tree) -> int:
    from repro_torch.launch.opcost import tensor_bytes
    from repro_torch.models.params import tree_flatten
    return sum(tensor_bytes(x) for x in tree_flatten(tree)[0])


def launch_train_check(dev, dry) -> dict:
    """(a) phase 9's training step for real, against its 1 x 1 dry run:
    the argument bytes and the FLOPs equal, the peak bytes in the band,
    and the roofline seconds beside the measured step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.opcost import OpCounter
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = get_config(SERVE_ARCH).replace(num_layers=TRAIN_LAYERS)
    opt = phase9_opt()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    g = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    state = init_train_state(cfg, opt, g)
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=g, device=dev, dtype=torch.int32)
             for k in ("tokens", "targets")}
    arg_b = tree_bytes(state) + tree_bytes(batch)
    step = make_train_step(cfg, opt)
    state, _ = step(state, batch)                  # warm-up
    torch.cuda.synchronize()
    with OpCounter(dev.type) as oc:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LAUNCH_TIMED):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(metrics["loss"])
    del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    want_b = dry["arg_bytes_per_dev"]
    pred = want_b + dry["temp_bytes_per_dev"] + dry["out_bytes_per_dev"]
    rf = dry["roofline"]
    roof_s = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    res = {"arg_bytes": arg_b, "dry_arg_bytes": want_b,
           "flops": oc.cost.flops, "dry_flops": rf["flops_per_dev"],
           "hbm_bytes": oc.cost.hbm_bytes, "dry_hbm_bytes":
           rf["bytes_per_dev"], "peak_bytes": peak,
           "predicted_peak_bytes": pred, "peak_ratio": peak / pred,
           "step_s": statistics.median(times), "step_times_s": times,
           "roofline": rf, "roofline_s": roof_s, "loss": loss,
           "dry_trace_s": dry["trace_s"], "dry_ops": dry["ops"],
           "real_ops": oc.cost.ops,
           "flops_by_dtype": oc.cost.flops_by_dtype}
    log(f"launch (a): {SERVE_ARCH} {TRAIN_LAYERS} layers, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, 1 x 1: argument bytes {arg_b:,} (dry run "
        f"{want_b:,}); FLOPs {oc.cost.flops:.6e} (dry run "
        f"{rf['flops_per_dev']:.6e}); HBM bytes counted "
        f"{oc.cost.hbm_bytes:.4e} (dry run {rf['bytes_per_dev']:.4e}); ops "
        f"{oc.cost.ops} (dry run "
        f"{dry['ops']}); peak {peak / 2**30:.3f} GiB against predicted "
        f"{pred / 2**30:.3f} GiB (ratio {peak / pred:.4f}, band "
        f"{LAUNCH_MEM_BAND}); step {res['step_s']:.4f} s against the "
        f"roofline's {roof_s:.4f} s (compute {rf['compute_s']:.4f} for "
        f"FLOPs by type {rf['flops_by_dtype']}, memory "
        f"{rf['memory_s']:.4f}, {rf['dominant']}) [{nvidia_smi_line()}]")
    if arg_b != want_b:
        raise AssertionError(f"argument bytes {arg_b} != the dry run's "
                             f"{want_b}")
    if (oc.cost.flops != rf["flops_per_dev"]
            or oc.cost.flops_by_dtype != rf["flops_by_dtype"]):
        raise AssertionError(f"FLOPs {oc.cost.flops_by_dtype} != the dry "
                             f"run's {rf['flops_by_dtype']}")
    if not LAUNCH_MEM_BAND[0] <= peak / pred <= LAUNCH_MEM_BAND[1]:
        raise AssertionError(f"peak {peak} / predicted {pred} = "
                             f"{peak / pred:.4f} outside {LAUNCH_MEM_BAND}")
    return res


def launch_prefill_check(dev, dry) -> dict:
    """(b) phase 8's dense prefill for real, against its 1 x 1 dry run:
    the argument bytes equal, the flash launches equal the dry run's
    flash sites, and the FLOPs the dry run's less the plain flash
    version's (the kernel's work is no aten op)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch.opcost import OpCounter, count
    from repro_torch.models import api
    cfg = get_config(SERVE_ARCH).replace(num_layers=TRAIN_LAYERS)
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SERVE_SEED))
    tokens = torch.randint(0, cfg.vocab_size, (1, LAUNCH_PREFILL),
                           device=dev, dtype=torch.int32)
    arg_b = tree_bytes(params) + tokens.numel() * tokens.element_size()
    with torch.no_grad():
        api.prefill(cfg, params, tokens)           # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        with OpCounter(dev.type) as oc:
            api.prefill(cfg, params, tokens)
        torch.cuda.synchronize()
        counts = launch_counts()
        times = []
        for _ in range(LAUNCH_TIMED):
            t0 = time.perf_counter()
            api.prefill(cfg, params, tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def meta(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device="meta")
    plain = count(fa_ref.flash_attention, meta(1, LAUNCH_PREFILL, h, d),
                  meta(1, LAUNCH_PREFILL, kv, d),
                  meta(1, LAUNCH_PREFILL, kv, d), True)[1].flops
    sites = dry["kernels"].get("flash_attention", 0)
    rf = dry["roofline"]
    res = {"arg_bytes": arg_b, "dry_arg_bytes": dry["arg_bytes_per_dev"],
           "flops": oc.cost.flops, "dry_flops": rf["flops_per_dev"],
           "plain_flash_flops": plain, "flash_launches":
           counts["flash_attention"], "dry_flash_sites": sites,
           "launches": counts, "prefill_s": statistics.median(times),
           "roofline": rf, "predicted_bytes": dry["arg_bytes_per_dev"]
           + dry["temp_bytes_per_dev"] + dry["out_bytes_per_dev"]}
    log(f"launch (b): prefill of {LAUNCH_PREFILL} tokens, {TRAIN_LAYERS} "
        f"layers, 1 x 1: argument bytes {arg_b:,} (dry run "
        f"{res['dry_arg_bytes']:,}); flash launches "
        f"{counts['flash_attention']} (dry-run sites {sites}); FLOPs "
        f"{oc.cost.flops:.6e} + {sites} x plain flash {plain:.6e} (dry run "
        f"{rf['flops_per_dev']:.6e}); prefill {res['prefill_s']:.4f} s "
        f"against the roofline's {max(rf['compute_s'], rf['memory_s']):.4f}"
        f" s ({rf['dominant']})")
    others = {k: n for k, n in counts.items() if k != "flash_attention"}
    if arg_b != res["dry_arg_bytes"]:
        raise AssertionError(f"prefill argument bytes {arg_b} != the dry "
                             f"run's {res['dry_arg_bytes']}")
    if (counts["flash_attention"] != sites or sites != cfg.num_layers
            or any(others.values())):
        raise AssertionError(f"prefill launches {counts} against the dry "
                             f"run's flash sites {sites}")
    if oc.cost.flops + sites * plain != rf["flops_per_dev"]:
        raise AssertionError(f"prefill FLOPs {oc.cost.flops} + {sites} x "
                             f"{plain} != the dry run's "
                             f"{rf['flops_per_dev']}")
    return res


def launch_phase(dev, out_dir) -> tuple:
    """Phase 17: the three dry runs, (a) and (b) against their artifacts,
    then (c) the 256-rank cell's row and its useful share.  Returns
    (results, the launch counts of (b)'s counted prefill)."""
    from repro_torch.launch import report
    t0 = time.perf_counter()
    dry = run_dryruns(out_dir)
    dry_s = time.perf_counter() - t0
    # TF32 on for the training step, as phase 9 runs it
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        res = {"train": launch_train_check(dev, dry["train"])}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    res["prefill"] = launch_prefill_check(dev, dry["prefill"])
    sh = dry["sharded"]
    log("launch (c): " + report.HEADER.splitlines()[0])
    log("launch (c): " + report.fmt_row(sh))
    log(f"launch (c): useful_ratio {sh['useful_ratio']:.4f} (band "
        f"{LAUNCH_USEFUL_BAND}); heaviest matmuls " + "; ".join(
            f"{k}: {f:.4g}" for k, f in sh["top_flops"][:4]))
    wire = sh["roofline"]["wire_bytes_per_dev"]
    log(f"launch (c): collective wire {wire:,.0f} B a device (repro's "
        f"{LAUNCH_WIRE_REPRO:,}); heaviest collectives " + "; ".join(
            f"{k}: {b:,.0f} B x {n}" for k, b, n in sh["top_wire"][:4]))
    if (sh["chips"] != 256 or sh["f64_leaks"] or not
            LAUNCH_USEFUL_BAND[0] <= sh["useful_ratio"]
            <= LAUNCH_USEFUL_BAND[1] or wire > LAUNCH_WIRE_REPRO):
        raise AssertionError(f"the sharded dry run: {sh}")
    res["sharded"] = sh
    res["dry_runs_s"] = dry_s
    res["dry_runs"] = {k: {kk: v[kk] for kk in ("trace_s", "ops",
                                                 "kernels", "torch")}
                       for k, v in dry.items()}
    return res, res["prefill"]["launches"]


# ---------------------------------------------------------------------------
# phase 18: the trainer's production layout (FSDP + tensor parallel)
# ---------------------------------------------------------------------------

# (a) phase 9's model at 1 of its 62 layers: the checkpoint round trip
# writes the whole state twice and reads it once (a 4-layer state is
# 25.84 GB; 1 layer's is 9.76 GB), which is what the phase's time allows
PROD_LAYERS = 1
PROD_STEPS = 3               # the failure hits the 3rd, after step 2's save
PROD_CKPT_EVERY = 2
PROD_TIMED = 3               # (b)'s timed steps at phase 9's cell
PROD_CHILD_TIMEOUT = 600     # (c), the 2 x 2 gloo script on the host


def production_2x2_start(out_dir, cases=None, name="production_2x2"):
    """(c) scripts/production_layout_2x2.py (its default cases, or
    ``cases``) on the host's CPU, started in the background: its stdout
    and stderr go to a log in ``out_dir``/``name`` (made absolute: the
    script's file store is a ``file://`` URL)."""
    d = os.path.abspath(os.path.join(out_dir, name))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    log_fh = open(os.path.join(d, "log.txt"), "w")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "production_layout_2x2.py"),
         "--out", d] + (["--cases", ",".join(cases)] if cases else []),
        stdout=log_fh, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    return proc, log_fh, d


def production_2x2_finish(proc, log_fh, d, tag="production (c)") -> dict:
    """(c) wait for the script and read its report (the last JSON line):
    every case within its limits of the one-process step."""
    try:
        rc = proc.wait(timeout=PROD_CHILD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_fh.close()
    with open(os.path.join(d, "log.txt")) as fh:
        text = fh.read()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    if rc != 0 or not lines:
        raise AssertionError(f"production 2 x 2 exited {rc}:\n"
                             f"{text[-3000:]}")
    report = json.loads(lines[-1])
    worst = {name: max(c["err"].items(), key=lambda kv: kv[1])
             for name, c in report["cases"].items()}
    log(f"{tag}: the 2 x 2 gloo script on the host's CPU, torch "
        f"{report['torch']}: ok {report['ok']}; worst reading by case "
        + ", ".join(f"{n} {k} {v:.3g}" for n, (k, v) in worst.items())
        + "; rank 0's matmul FLOPs / (one process's / 4) by case (limit) "
        + ", ".join(f"{n} {c['flops_ratio']:.4f} ({c['flops_limit']})"
                    for n, c in report["cases"].items())
        + "; local state bytes = the dry run's on every rank: "
        + str(all(c["local_bytes_by_rank"] == c["dryrun_bytes_by_rank"]
                  for c in report["cases"].values())))
    if not report["ok"]:
        raise AssertionError(f"production 2 x 2: {report}")
    return report


def _local_bytes(tree) -> int:
    from repro_torch.models.params import tree_flatten
    return sum(x.to_local().numel() * x.to_local().element_size()
               for x in tree_flatten(tree)[0])


def production_trainer_check(dev, store, mesh, root) -> dict:
    """(a) the Trainer on the production layout of a (1, 1) mesh against
    the plain Trainer, same seed and batches; its checkpoint round trip
    with an injected failure."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.models.params import tree_flatten
    from repro_torch.train import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(SERVE_ARCH).replace(num_layers=PROD_LAYERS)
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=PROD_STEPS)
    source = train_source(store, dev, cfg, seq=TRAIN_SEQ,
                          batch=TRAIN_BATCH)
    try:
        it = iter(source)
        batches = [next(it) for _ in range(PROD_STEPS + 1)]
    finally:
        source.close()
    ck = os.path.join(root, "ckpt")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, opt, TrainerConfig(
        steps=PROD_STEPS, ckpt_dir=ck, ckpt_every=PROD_CKPT_EVERY,
        log_every=1, max_restarts=1, seed=TRAIN_SEED), device=dev,
        mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_flatten(trainer.state)[0]
    if trainer.step_fn.layout != "production" or not all(
            isinstance(x, DTensor) for x in leaves):
        raise AssertionError(f"production (a): layout "
                             f"{trainer.step_fn.layout}, leaves "
                             f"{sorted({type(x).__name__ for x in leaves})}")
    held = {}

    def fault(step_before):
        # first time at PROD_CKPT_EVERY: keep the state its checkpoint
        # holds, then fail; the second time (after the restart) the
        # restored state must be that one bit for bit
        if step_before != PROD_CKPT_EVERY:
            return
        if "saved" not in held:
            held["saved"] = [x.to_local().clone()
                             for x in tree_flatten(trainer.state)[0]]
            raise RuntimeError("injected failure")
        held["restored_bit_equal"] = all(
            torch.equal(x.to_local(), y) for x, y in
            zip(tree_flatten(trainer.state)[0], held.pop("saved")))

    t0 = time.perf_counter()
    hist = trainer.run(iter(batches), fault_hook=fault)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    restarts = trainer.restarts
    del trainer, leaves
    gc.collect()
    torch.cuda.empty_cache()
    # the plain Trainer on the batches the production run trained on
    # (the one the failure hit was dropped, as the restart replays)
    kept = batches[:PROD_CKPT_EVERY] + batches[PROD_CKPT_EVERY + 1:]
    plain = Trainer(cfg, opt, TrainerConfig(steps=PROD_STEPS, log_every=1,
                                            seed=TRAIN_SEED), device=dev)
    phist = plain.run(iter(kept))
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("loss", "grad_norm", "tokens")
    got = [[h[k] for k in keys] for h in hist]
    want = [[h[k] for k in keys] for h in phist]
    res = {"layers": PROD_LAYERS, "steps": [h["step"] for h in hist],
           "restarts": restarts, "init_s": init_s, "run_s": run_s,
           "production": got, "plain": want, "keys": keys,
           "bit_equal": got == want,
           "restored_bit_equal": held.get("restored_bit_equal")}
    log(f"production (a): Trainer on the production layout of a (1, 1) "
        f"NCCL mesh, {SERVE_ARCH} at full width, {PROD_LAYERS} of 62 "
        f"layers, float32 AdamW, {TRAIN_BATCH} x {TRAIN_SEQ} tokens from "
        f"the LM data plane: {len(hist)} steps, {restarts} restart from "
        f"the step-{PROD_CKPT_EVERY} checkpoint after an injected failure "
        f"(restored state bit-equal: {res['restored_bit_equal']}); "
        f"(loss, grad_norm, tokens) by step {got} against the plain "
        f"Trainer's {want}: bit-equal {res['bit_equal']}; init "
        f"{init_s:.2f} s, run {run_s:.2f} s [{nvidia_smi_line()}]")
    if (res["steps"] != list(range(1, PROD_STEPS + 1)) or restarts != 1
            or not res["bit_equal"] or not res["restored_bit_equal"]):
        raise AssertionError(f"production (a): {res}")
    return res


# the production layout's step before each weight was placed at its use
# (models/sharding.py::product_operands), median seconds: chip_smoke on an
# NVIDIA H100 80GB HBM3, 700.00 W, torch 2.11.0+cu128; printed beside
# this run's
PROD_STEP_BEFORE_S = {"production (b)": 1.3555, "moe production (a)": 1.3423,
                      "moe production (b)": 3.1876}


def production_cost_check(dev, mesh, phase9, launch) -> dict:
    """(b) phase 9's cell (4 layers, 2 x 4,096 tokens, phase 9's AdamW)
    on the production layout of the (1, 1) mesh: the per-rank argument
    bytes against the dry run's, and the step's time and device busy
    share against the plain step's (phase 17 (a), same cell and batch
    shape) and phase 9's."""
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(SERVE_ARCH).replace(num_layers=TRAIN_LAYERS)
    trainer = Trainer(cfg, phase9_opt(), TrainerConfig(
        steps=TRAIN_WARM + TRAIN_TIMED, seed=TRAIN_SEED), device=dev,
        mesh=mesh)
    g = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=g, device=dev,
                              dtype=torch.int32).cpu().numpy()
             for k in ("tokens", "targets")}
    arg_b = _local_bytes(trainer.state) + sum(
        v.nbytes for v in batch.values())
    step = trainer.step_fn
    state, _ = step(trainer.state, batch)            # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(PROD_TIMED):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prof, prof_ms = profiled_seen(lambda: step(state, batch))
    dev_ms = kernel_device_ms(prof)
    del prof, state, trainer, step
    gc.collect()
    torch.cuda.empty_cache()
    lt = launch["train"]
    med = statistics.median(times)
    res = {"arg_bytes": arg_b, "dry_arg_bytes": lt["dry_arg_bytes"],
           "step_s": med, "step_times_s": times,
           "plain_step_s": lt["step_s"],
           "phase9_step_ms_median": phase9["step_ms_median"],
           "phase9_device_busy_share": phase9["profile"][
               "device_busy_share"],
           "profile": {"wall_ms": prof_ms, "device_ms": dev_ms,
                       "device_busy_share": dev_ms / prof_ms},
           "plain_ops": lt["real_ops"],
           "host_us_per_op": (med - lt["step_s"]) / lt["real_ops"] * 1e6,
           "loss": float(metrics["loss"])}
    log(f"production (b): phase 9's cell ({TRAIN_LAYERS} layers) on the "
        f"production layout: argument bytes {arg_b:,} (dry run "
        f"{res['dry_arg_bytes']:,}); step {med:.4f} s (median of "
        f"{PROD_TIMED}; {PROD_STEP_BEFORE_S['production (b)']:.4f} s before "
        f"each weight was placed at its use) against the plain step's "
        f"{lt['step_s']:.4f} s "
        f"(phase 17 (a)) and phase 9's {phase9['step_ms_median'] / 1e3:.4f}"
        f" s; device busy {res['profile']['device_busy_share']:.4f} "
        f"(phase 9 {res['phase9_device_busy_share']:.4f}); DTensor's host "
        f"cost {res['host_us_per_op']:.2f} us a plain op over "
        f"{lt['real_ops']} ops [{nvidia_smi_line()}]")
    if arg_b != res["dry_arg_bytes"] or not np.isfinite(res["loss"]):
        raise AssertionError(f"production (b): {res}")
    return res


def production_phase(dev, store, out_dir, phase9, launch) -> dict:
    """Phase 18: (c) started on the host's CPU, then (a) and, after (c)
    has ended (its four processes would share the host with the timed
    steps), (b), over an NCCL group of one rank (a file store) and a
    (1, 1) mesh; TF32 on, as phase 9."""
    import torch.distributed as dist
    from repro_torch.runtime.elastic import build_mesh
    root = os.path.abspath(os.path.join(out_dir, "production"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    child = production_2x2_start(out_dir)
    res = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="file://" + os.path.join(root, "pg"),
                            rank=0, world_size=1)
    try:
        mesh = build_mesh(model_parallel=1, device=dev)
        res["trainer"] = production_trainer_check(dev, store, mesh, root)
        t0 = time.perf_counter()
        res["gloo_2x2"] = production_2x2_finish(*child)
        child = None
        res["gloo_2x2_wait_s"] = time.perf_counter() - t0
        res["cost"] = production_cost_check(dev, mesh, phase9, launch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.destroy_process_group()
        if child is not None:
            child[0].kill()
            child[0].wait()
            child[1].close()
        shutil.rmtree(root, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 19: the MoE and hybrid families on the production layout
# ---------------------------------------------------------------------------

MOE_PROD_STEPS = 3
# (b) jamba at smoke widths (one period at full width is 90.3 GB of bf16)
# over phase 15's 2 x 4,096 tokens: more than 4,096 a step, so every row
# routes on its own, as olmoe's in (a)
MOE_PROD_JAMBA = {"arch": "jamba-1.5-large-398b", "seq": 4096, "batch": 2}
# (c), production_layout_2x2.py: olmoe_ep is olmoe with moe_ep on the
# same layout, its MoE layers routed by explicit hops over "model"
MOE_PROD_2X2_CASES = ("olmoe", "jamba", "olmoe_ep")


def moe_production_run(dev, store, mesh, cfg, seq, batch, tag,
                       profile=True) -> dict:
    """(a), (b): the Trainer on the production layout of the (1, 1) mesh
    and the plain Trainer, same seed and the same batches from the LM
    data plane, MOE_PROD_STEPS steps each; (loss, grad_norm, tokens) by
    step and the routed pairs dropped for capacity must be bit-equal.
    Each run's step time (median of the steps after the first) and, with
    ``profile``, device busy share (one profiled step more: 20-75 s of
    profiler on the card, so (b) goes without); the production state's
    argument bytes against ``launch/dryrun.py::operand_layout``'s."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.dryrun import operand_layout
    from repro_torch.models.params import tree_flatten
    from repro_torch.train import OptConfig
    from repro_torch.train.steps import train_state_axes, train_state_shapes
    from repro_torch.train.trainer import Trainer, TrainerConfig
    opt = OptConfig(lr=FAMILY_TRAIN_LR, warmup_steps=1,
                    total_steps=MOE_PROD_STEPS + 1)
    t0 = time.perf_counter()
    source = train_source(store, dev, cfg, seq=seq, batch=batch)
    try:
        it = iter(source)
        batches = [next(it) for _ in range(MOE_PROD_STEPS + 1)]
    finally:
        source.close()
    source_s = time.perf_counter() - t0
    runs = {}
    for name, m in (("production", mesh), ("plain", None)):
        torch.cuda.reset_peak_memory_stats()
        with moe_drop_tally() as tally:
            t0 = time.perf_counter()
            trainer = Trainer(cfg, opt, TrainerConfig(
                steps=MOE_PROD_STEPS, log_every=1, seed=TRAIN_SEED),
                device=dev, mesh=m)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            hist = trainer.run(iter(batches[:MOE_PROD_STEPS]))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        run = {"hist": [[h[k] for k in ("loss", "grad_norm", "tokens")]
                        for h in hist],
               "init_s": t1 - t0, "run_s": t2 - t1,
               "step_times_s": [t["data_wait_s"] + t["grad_s"]
                                + t["update_s"]
                                for t in trainer.step_times],
               "drops": drop_shares(tally)["all"],
               "layout": trainer.step_fn.layout,
               "step_s": statistics.median(
                   t["data_wait_s"] + t["grad_s"] + t["update_s"]
                   for t in trainer.step_times[1:]),
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if m is not None:
            leaves = tree_flatten(trainer.state)[0]
            run["dtensor_leaves"] = all(isinstance(x, DTensor)
                                        for x in leaves)
            run["arg_bytes"] = _local_bytes(trainer.state)
            run["dry_arg_bytes"] = operand_layout(
                (train_state_shapes(cfg, opt),),
                (train_state_axes(cfg, opt),), m, state=(cfg, opt))[1]
            del leaves
        if profile:
            step, state = trainer.step_fn, trainer.state
            t0 = time.perf_counter()
            prof, prof_ms = profiled_seen(lambda: step(state, batches[-1]))
            run["busy_share"] = kernel_device_ms(prof) / prof_ms
            run["profile_s"] = time.perf_counter() - t0
            del prof, step, state
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        runs[name] = run
    prod, plain = runs["production"], runs["plain"]
    res = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "seq": seq, "batch": batch,
           "source_s": source_s, **runs,
           "bit_equal": prod["hist"] == plain["hist"]
           and prod["drops"] == plain["drops"]}
    log(f"{tag}: {cfg.name} (d_model {cfg.d_model}, {cfg.num_layers} "
        f"layers, {cfg.num_experts} experts, {cfg.experts_per_token} a "
        f"token), {batch} x {seq} tokens from the LM data plane, "
        f"{MOE_PROD_STEPS} steps on the {prod['layout']} layout of a (1, 1)"
        f" NCCL mesh against the plain Trainer: (loss, grad_norm, tokens) "
        f"by step {prod['hist']} vs {plain['hist']}, dropped pairs "
        f"{prod['drops']['dropped']} of {prod['drops']['pairs']} vs "
        f"{plain['drops']['dropped']} of {plain['drops']['pairs']}: "
        f"bit-equal {res['bit_equal']}; argument bytes {prod['arg_bytes']:,}"
        f" (dry run {prod['dry_arg_bytes']:,}); step {prod['step_s']:.4f} s"
        f" ({PROD_STEP_BEFORE_S[tag]:.4f} s before each weight was placed "
        f"at its use) vs {plain['step_s']:.4f} s"
        + (f", busy {prod['busy_share']:.4f} vs {plain['busy_share']:.4f}"
           if profile else "")
        + f"; peak {prod['peak_memory_bytes'] / 2**30:.2f} vs "
        f"{plain['peak_memory_bytes'] / 2**30:.2f} GiB [{nvidia_smi_line()}]")
    if (prod["layout"] != "production" or not prod["dtensor_leaves"]
            or not res["bit_equal"] or len(prod["hist"]) != MOE_PROD_STEPS
            or prod["arg_bytes"] != prod["dry_arg_bytes"]
            or not np.isfinite(prod["hist"]).all()):
        raise AssertionError(f"{tag}: {res}")
    return res


def moe_production_phase(dev, store, out_dir) -> dict:
    """Phase 19: (c) the 2 x 2 gloo script's MoE cases started on the
    host's CPU, then (a) olmoe at full width, phase 15's 4 of 16 layers,
    and (b) jamba at smoke widths on the production layout of a (1, 1)
    mesh over an NCCL group of one rank (a file store), each beside the
    plain Trainer, TF32 on as phase 18; then (c)'s report."""
    import torch.distributed as dist
    from repro_torch.configs import smoke_config
    from repro_torch.runtime.elastic import build_mesh
    root = os.path.abspath(os.path.join(out_dir, "moe_production"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    child = production_2x2_start(out_dir, MOE_PROD_2X2_CASES,
                                 "moe_production_2x2")
    res = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="file://" + os.path.join(root, "pg"),
                            rank=0, world_size=1)
    try:
        mesh = build_mesh(model_parallel=1, device=dev)
        spec = FAMILY_TRAIN["moe"]
        res["olmoe"] = moe_production_run(
            dev, store, mesh, family_train_cfg("moe"), spec["seq"],
            spec["batch"], "moe production (a)")
        res["jamba"] = moe_production_run(
            dev, store, mesh, smoke_config(MOE_PROD_JAMBA["arch"]),
            MOE_PROD_JAMBA["seq"], MOE_PROD_JAMBA["batch"],
            "moe production (b)", profile=False)
        t0 = time.perf_counter()
        report = production_2x2_finish(*child, tag="moe production (c)")
        child = None
        res["gloo_2x2"] = report
        res["gloo_2x2_wait_s"] = time.perf_counter() - t0
        routed = {n: c for n, c in report["cases"].items()
                  if "routing_equal" in c}
        hops = {n: c for n, c in report["cases"].items()
                if "all_to_all" in c}
        log("moe production (c): routing equal to one process, dropped "
            "pairs of routed: " + ", ".join(
                f"{n} {c['routing_equal']} {c['dropped']} of {c['pairs']}"
                for n, c in routed.items())
            + "; moe_ep all-to-alls on rank 0: " + ", ".join(
                f"{n} {c['all_to_all']}" for n, c in hops.items()))
        if (not all(c["routing_equal"] and c["dropped"] > 0
                    for c in routed.values())
                or not all(c["all_to_all"] > 0 for c in hops.values())
                or len(routed) + len(hops) != len(MOE_PROD_2X2_CASES)):
            raise AssertionError(f"moe production (c): {report}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.destroy_process_group()
        if child is not None:
            child[0].kill()
            child[0].wait()
            child[1].close()
        shutil.rmtree(root, ignore_errors=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for the measurements JSON and the "
                         "ptxas log")
    ap.add_argument("--durable-child", metavar="DIR",
                    help="(phase 14's crash rounds) run the durable feed "
                         "into DIR until killed")
    ap.add_argument("--seed", type=int, default=SEED_CRASH,
                    help="the durable child's stream seed")
    ap.add_argument("--dryrun-child", metavar="CELL",
                    help="(phase 17) trace one dry-run cell and exit")
    args = ap.parse_args()
    out_dir = args.out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.core  # noqa: F401  (fails outside a checkout)
    if args.durable_child:
        return durable_child(args.durable_child, args.seed)
    if args.dryrun_child:
        return dryrun_child(args.dryrun_child, out_dir)
    from repro_torch.core import RefStore
    from repro_torch.core.enrich import queries as Q
    from repro_torch.kernels import (all_kernels, build_all, launch_counts,
                                     path_stats, reset_launch_counts,
                                     reset_path_stats)

    dev = torch.device("cuda", 0)
    # full float32 products in the plain versions and the cross-checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    # phase 1
    log(f"device: {name} | nvidia-smi name, power.limit: {smi}")
    # phase 2
    t0 = time.perf_counter()
    build_all()
    log(f"build: {len(all_kernels())} kernels in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_ptxas.log"), "w") as fh:
        for k in all_kernels():
            fh.write(f"== {k.name}\n{k.build_log}\n")
    # phase 3
    rng = np.random.default_rng(2019)
    kernels = [check_sorted_probe(dev, rng), check_radius_join(dev, rng),
               check_segment_sum(dev, rng), check_segment_topk(dev, rng),
               check_flash_attention(dev, rng)]
    kernels[3]["launch_profile"] = check_topk_launches(dev, rng)
    check_spatial_launches(kernels[1]["by_case"])
    # phase 4
    t0 = time.perf_counter()
    store = RefStore()
    Q.make_reference_tables(store, scale=1.0, seed=SEED_TABLES)
    log(f"tables: scale 1.0 built in {time.perf_counter() - t0:.1f} s")
    layers = layer_breakdown(dev, store)
    # the feed path (phases 4-6) runs from counts of 0
    reset_launch_counts()
    feed, split = run_feed(dev, store)
    counts = launch_counts()
    inv, builds = split["invocations"], split["state_builds"]
    # per batch: Q1's probe, Q4's join; per Q6 state build: the income
    # join and the two district group-bys; the feed issues no top-k
    want = {"hash_probe": inv + builds, "spatial_join": inv,
            "segment_reduce": 2 * builds, "segment_topk": 0,
            "flash_attention": 0}
    log(f"feed: kernel launches {counts} (expected {want})")
    if counts != want or 0 in (counts["hash_probe"], counts["spatial_join"],
                               counts["segment_reduce"]):
        raise AssertionError(f"launch counts {counts} != {want}")
    # phase 5
    rows = stored_rows(feed)
    checked = cross_check(store, rows)
    # phase 6 (the query closes the main path: its launches count too)
    q_s, qst = check_query(feed, rows)
    after = launch_counts()
    if (qst.agg_kernel_dispatches == 0 or qst.agg_fallback_dispatches
            or after["segment_reduce"] - counts["segment_reduce"]
            != qst.agg_kernel_dispatches):
        raise AssertionError(f"query did not run the segment_sum kernel "
                             f"({after} after the feed's {counts})")
    # phase 7, the read path, from counts and path stats of 0: its top-k
    # launches must all be the kernel path's, and the card must take no
    # plain version (the CPU runs beside it record "reference")
    from repro_torch.core.enrich import dispatch
    reset_launch_counts()
    reset_path_stats()
    dispatch.reset_bucket_stats()
    read = read_path(dev, store, out_dir)
    rcounts = launch_counts()
    paths = path_stats()
    hist = dispatch.bucket_stats()
    log("read: kernel dispatches by (op, row bucket): " + ", ".join(
        f"{op}@{b}: {n}" for (op, b), n in sorted(hist.items())))
    kernel_path = paths.get(("segment_topk", "kernel"), 0)
    card_plain = paths.get(("segment_topk", "plain_on_card"), 0)
    log(f"read: launches {rcounts}; segment_topk kernel-path dispatches "
        f"{kernel_path}, plain-path dispatches on the card {card_plain}")
    if (rcounts["segment_topk"] == 0 or card_plain
            or kernel_path != rcounts["segment_topk"]):
        raise AssertionError("the read path did not run the segment_topk "
                             "kernel for every top-k")
    if rcounts["segment_reduce"] == 0:
        raise AssertionError("the read path did not run segment_sum")
    sum_hits = sum(n for (op, _), n in hist.items() if op == "segment_sum")
    topk_hits = sum(n for (op, _), n in hist.items() if op == "segment_topk")
    if (sum_hits, topk_hits) != (rcounts["segment_reduce"],
                                 rcounts["segment_topk"]):
        raise AssertionError(f"bucket histogram ({sum_hits} sums, "
                             f"{topk_hits} top-k) != launches {rcounts}")
    read["bucket_histogram"] = [{"op": op, "rows": b, "dispatches": n}
                                for (op, b), n in sorted(hist.items())]
    read["aggregation_device_ms"] = weigh_buckets(dev, hist, rng)
    # phase 14 (run here, before serving takes the card's memory): the
    # durable, elastic feed of the whole workload, from counts and path
    # stats of 0.  Its three kernels must launch, segment_topk (Q3's
    # 50,000 countries are outside its envelope) and flash must not
    reset_launch_counts()
    reset_path_stats()
    durable = durable_feed(dev, store, out_dir, smi)
    dcounts = launch_counts()
    dpaths = path_stats()
    log(f"durable: launches {dcounts}; top-k paths "
        f"{ {p: n for p, n in dpaths.items() if p[0] == 'segment_topk'} } "
        f"[{smi}]")
    if (dcounts["segment_topk"] or dcounts["flash_attention"]
            or dpaths.get(("segment_topk", "kernel"))
            or not dpaths.get(("segment_topk", "plain_on_card"))
            or 0 in (dcounts["hash_probe"], dcounts["spatial_join"],
                     dcounts["segment_reduce"])):
        raise AssertionError(f"the durable feed's launches {dcounts} or "
                             f"paths {dpaths} are not its path's")
    # phase 8, serving, from counts and path stats of 0: every admission
    # runs the flash kernel once per layer, in the prefill that gives its
    # first token, and no attention takes the plain version
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config(SERVE_ARCH).replace(num_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SERVE_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"serve: {SERVE_ARCH} at full width, {cfg.num_layers} of 62 "
        f"layers, {api.param_count(cfg):,} parameters ({cfg.param_dtype}) "
        f"drawn in {init_s:.3f} s")
    serve_warmup(cfg, params, dev)
    threads = host_threads("serve")
    reset_launch_counts()
    reset_path_stats()
    serve = serve_path(cfg, params, dev)
    serve["host"] = threads
    scounts = launch_counts()
    spaths = path_stats()
    want = {n: 0 for n in scounts}
    want["flash_attention"] = cfg.num_layers * serve["prefills"]
    log(f"serve: launches {scounts} (expected {want}); attention paths "
        f"{spaths}")
    if scounts != want or spaths.get(("flash_attention", "plain_on_card")):
        raise AssertionError("the serving path did not run the flash "
                             "kernel for every prefill attention")
    serve["profile"] = profile_serving(cfg, params, dev)
    serve["attention_check"] = serve_attention_check(cfg, params, dev)
    serve["cross_check"] = serve_cross_check(cfg, params, dev)
    serve["init_s"] = init_s
    del params
    # phase 9, training, from counts and path stats of 0: the data plane
    # and the trainer launch no hand kernel (UDF2 is a dense match; the
    # flash kernel is forward-only), and every training attention is the
    # chunked plain version on the card, twice a layer a fwd+bwd (the
    # checkpointed layer's first pass and its recompute).  Float32
    # products in TF32: exact for the bf16 operands of the scores and the
    # head, p rounded to 10 bits in P.V
    torch.backends.cuda.matmul.allow_tf32 = True
    reset_launch_counts()
    reset_path_stats()
    train, trainer, spare = train_path(dev, store)
    tcounts, tpaths = train.pop("launches"), train.pop("paths")
    passes = 2 * TRAIN_LAYERS * (TRAIN_WARM + TRAIN_TIMED + 1)
    log(f"train: launches {tcounts}; attention paths {tpaths} (expected "
        f"{passes} plain_on_card)")
    if any(tcounts.values()) or tpaths != {
            ("flash_attention", "plain_on_card"): passes}:
        raise AssertionError("the training path launched a kernel or took "
                             "an attention path other than the chunked "
                             "plain version")
    train_profile(train, trainer, spare)
    del trainer
    train["cross_check"] = train_cross_check(
        dev, {k: v[:1, :CHECK_SEQ].copy() for k, v in spare.items()})
    torch.backends.cuda.matmul.allow_tf32 = False
    # phases 10-12, serving the moe, ssm and vlm families whole, each from
    # counts and path stats of 0, after phase 9's state is freed
    del spare
    gc.collect()
    torch.cuda.empty_cache()
    log(f"after phase 9: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated on the card")
    families, fam_counts = {}, {}
    for fam in FAMILY_SERVE:
        families[fam], fam_counts[fam] = family_phase(fam, dev)
    # phase 15, training the moe, ssm, vlm and encdec families, each from
    # counts and path stats of 0, with TF32 on as phase 9 (after Q5 is
    # held to the CPU under it), and back off as phase 9 leaves it
    t15 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = True
    q5_tf32 = check_q5_under_tf32(dev, store)
    trains, train_counts = {}, {}
    for fam in FAMILY_TRAIN:
        trains[fam], train_counts[fam] = family_train(fam, dev, store)
    torch.backends.cuda.matmul.allow_tf32 = False
    phase15_s = time.perf_counter() - t15
    # phase 16, the distributed modules at world size 1, from counts of 0:
    # no hand kernel lies on them
    t16 = time.perf_counter()
    reset_launch_counts()
    reset_path_stats()
    distributed = distributed_phase(dev, out_dir)
    dist_counts = launch_counts()
    if any(dist_counts.values()):
        raise AssertionError(f"the distributed phase launched {dist_counts}")
    phase16_s = time.perf_counter() - t16
    log(f"phases 15-16: {phase15_s:.1f} + {phase16_s:.1f} s [{smi}]")
    # phase 17, the launch tooling's dry runs held to the card, from
    # counts of 0: the prefill launches flash once a layer
    t17 = time.perf_counter()
    reset_launch_counts()
    launch, launch_counts_17 = launch_phase(dev, out_dir)
    phase17_s = time.perf_counter() - t17
    log(f"phase 17: {phase17_s:.1f} s [{smi}]")
    # phase 18, the trainer's production layout, from counts and path
    # stats of 0: no hand kernel lies on it (training attention is the
    # plain chunked version)
    t18 = time.perf_counter()
    reset_launch_counts()
    reset_path_stats()
    production = production_phase(dev, store, out_dir, train, launch)
    prod_counts = launch_counts()
    prod_paths = path_stats()
    if any(prod_counts.values()) or set(prod_paths) - {
            ("flash_attention", "plain_on_card")}:
        raise AssertionError(f"the production layout launched "
                             f"{prod_counts} or took paths {prod_paths}")
    phase18_s = time.perf_counter() - t18
    log(f"phase 18: {phase18_s:.1f} s [{smi}]")
    # phase 19, the MoE and hybrid families on the production layout, from
    # counts and path stats of 0: MoE routing has no hand kernel, and
    # training attention is the plain chunked version
    t19 = time.perf_counter()
    reset_launch_counts()
    reset_path_stats()
    moe_production = moe_production_phase(dev, store, out_dir)
    moe_prod_counts = launch_counts()
    moe_prod_paths = path_stats()
    if any(moe_prod_counts.values()) or set(moe_prod_paths) - {
            ("flash_attention", "plain_on_card")}:
        raise AssertionError(f"the MoE production layout launched "
                             f"{moe_prod_counts} or took paths "
                             f"{moe_prod_paths}")
    phase19_s = time.perf_counter() - t19
    log(f"phase 19: {phase19_s:.1f} s [{smi}]")
    names = {"sorted_probe": "hash_probe", "radius_join": "spatial_join",
             "segment_sum": "segment_reduce", "segment_topk": "segment_topk",
             "flash_attention": "flash_attention"}
    for k in kernels:
        by_path = {"feed": after[names[k["name"]]],
                   "read_path": rcounts[names[k["name"]]],
                   "serve": scounts[names[k["name"]]],
                   "train": tcounts[names[k["name"]]],
                   "feed_durable": dcounts[names[k["name"]]],
                   **{f"serve_{fam}": c[names[k["name"]]]
                      for fam, c in fam_counts.items()},
                   **{f"train_{fam}": c[names[k["name"]]]
                      for fam, c in train_counts.items()},
                   "train_distributed": dist_counts[names[k["name"]]],
                   "launch": launch_counts_17[names[k["name"]]],
                   "train_production": prod_counts[names[k["name"]]],
                   "train_moe_production": moe_prod_counts[
                       names[k["name"]]]}
        k["launches_by_path"] = by_path
        k["launches"] = sum(by_path.values())
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_device_ms")
    line = {"kernels": [{kk: k[kk] for kk in keys} for k in kernels]}
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": kernels,
                   "feed": split, "layers": layers,
                   "cross_checked_rows": checked,
                   "query_s": q_s, "read_path": read, "serve": serve,
                   "train": train, "families": families,
                   "durable": durable, "train_families": trains,
                   "q5_tf32": q5_tf32, "distributed": distributed,
                   "launch": launch, "production": production,
                   "moe_production": moe_production,
                   "phase_seconds": {"15": phase15_s, "16": phase16_s,
                                     "17": phase17_s, "18": phase18_s,
                                     "19": phase19_s}},
                  fh, indent=1)
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
