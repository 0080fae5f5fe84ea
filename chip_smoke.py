"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device line (torch's name, nvidia-smi's name and power limit);
  2. build the three hand kernels from src/repro_torch/kernels/*/csrc,
     one nvcc per source, all at once;
  3. hold each kernel against its plain PyTorch version on the card at the
     enrichment feed's shapes (seeded numpy inputs) and time kernel, plain
     version and the one PyTorch call computing the same function;
  4. the feed: a fused Q1 -> Q4 -> Q6 plan over 20 x 6,720 tweets at the
     paper's reference cardinalities (scale 1.0), through FeedManager;
     every kernel's launch counter must grow during this run;
  5. cross-check the first 2 frames against a ComputingRunner on the CPU
     (plain versions): every output column equal;
  6. a group_by("country") count/mean query over the store, against numpy.
Prints one JSON line of kernels, then the device JSON as the last line.
Measurements also go to <--out>/chip_smoke.json (default smoke_out/).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): memory and float32 rates
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

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


def bound(nbytes: float, nops: float, peak_ops: float = PEAK_F32_S):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / peak_ops * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_sorted_probe(dev, rng):
    from repro_torch.core.refdata import KEY_SENTINEL
    from repro_torch.kernels.hash_probe import kernel, ref
    r_valid, r = 50_000, 50_176
    keys = np.full(r, KEY_SENTINEL, np.int64)
    keys[:r_valid] = np.sort(rng.choice(200_000, r_valid, replace=False))
    probe = rng.integers(0, 200_000, BATCH).astype(np.int64)  # ~1/4 hit
    probe[:64] = KEY_SENTINEL                                 # sentinels
    probe[64:128] = probe[128:192]                            # duplicates
    probe[192:256] = -5                                       # below all
    p, k = t(probe, dev), t(keys, dev)
    gi, gf = kernel.sorted_probe(p, k)
    wi, wf = ref.sorted_probe(p, k)
    torch.cuda.synchronize()
    if not (torch.equal(gi, wi) and torch.equal(gf, wf)):
        raise AssertionError("sorted_probe kernel != plain version")
    err = float((gi.long() - wi.long()).abs().max())
    ms = time_ms(lambda: kernel.sorted_probe(p, k))
    plain = time_ms(lambda: ref.sorted_probe(p, k))
    lib = time_ms(lambda: torch.searchsorted(k, p))
    nbytes = BATCH * 8 + r * 8 + BATCH * (4 + 1)
    b_ms, b_by = bound(nbytes, BATCH * np.ceil(np.log2(r)))
    log(f"kernel sorted_probe B={BATCH} R={r}: max_abs_err={err} "
        f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
        f"(torch.searchsorted) bound_ms={b_ms:.6f} ({b_by}) "
        f"hits={int(gf.sum())}")
    return {"name": "sorted_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/hash_probe/csrc/hash_probe.cu",
            "replaces": "src/repro/kernels/hash_probe/kernel.py:75",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def check_radius_join(dev, rng):
    from repro_torch.kernels.spatial_join import kernel, ref
    r_valid, r = 50_000, 50_176
    f = np.float32
    px = rng.uniform(-60, 60, BATCH).astype(f)
    py = rng.uniform(-180, 180, BATCH).astype(f)
    rx = rng.uniform(-60, 60, r).astype(f)
    ry = rng.uniform(-180, 180, r).astype(f)
    # a few probes exactly on reference points and on the radius boundary
    px[:8], py[:8] = rx[:8], ry[:8]
    px[8:16], py[8:16] = rx[8:16] + f(1.5), ry[8:16]
    valid = np.arange(r) < r_valid
    args = [t(a, dev) for a in (px, py, rx, ry)]
    vt = t(valid, dev)
    out, err = {}, 0.0
    for k in (8, 1):
        gi, gd, gc = kernel.radius_join(*args, 1.5, k, vt)
        wi, wd, wc = ref.radius_join(*args, 1.5, k, vt)
        torch.cuda.synchronize()
        same_inf = torch.equal(torch.isinf(gd), torch.isinf(wd))
        if not (torch.equal(gi, wi) and torch.equal(gc, wc) and same_inf):
            raise AssertionError(f"radius_join k={k} kernel != plain")
        fin = torch.isfinite(wd)
        derr = float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0
        if derr != 0.0:
            raise AssertionError(f"radius_join k={k} dist2 differs by "
                                 f"{derr} (same formula, same rounding)")
        err = max(err, derr)
        ms = time_ms(lambda: kernel.radius_join(*args, 1.5, k, vt))
        plain = time_ms(lambda: ref.radius_join(*args, 1.5, k, vt), reps=5)
        p2 = torch.stack(args[:2], 1)
        r2 = torch.stack(args[2:], 1)[:r_valid]
        lib = time_ms(lambda: torch.topk(torch.cdist(p2, r2), k,
                                         largest=False), reps=5)
        nbytes = BATCH * 8 + r * 9 + BATCH * k * 8 + BATCH * 4
        b_ms, b_by = bound(nbytes, 5.0 * BATCH * r_valid)
        log(f"kernel radius_join B={BATCH} R={r} k={k} r=1.5: "
            f"max_abs_err={derr} ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (cdist+topk) bound_ms={b_ms:.6f} "
            f"({b_by}) in_radius={int(gc.sum())}")
        out[k] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                  "bound_ms": b_ms, "bound_by": b_by}
    return {"name": "radius_join", "route": "cuda",
            "source": ("src/repro_torch/kernels/spatial_join/csrc/"
                       "spatial_join.cu"),
            "replaces": "src/repro/kernels/spatial_join/kernel.py:103",
            "max_abs_err": err, **out[8], "k1": out[1]}


def check_segment_sum(dev, rng):
    from repro_torch.kernels.segment_reduce import kernel, ref
    r, s = 1_000_192, 16_385
    seg = rng.integers(-2, s + 2, r).astype(np.int32)   # some dropped
    st = t(seg, dev)
    keep = (seg >= 0) & (seg < s)
    rows = {}
    for dt in (np.int32, np.int64, np.float32, np.float64):
        if np.issubdtype(dt, np.integer):
            v = rng.integers(-1000, 1000, r).astype(dt)
        else:
            v = rng.normal(size=r).astype(dt)
        vt = t(v, dev)
        got = kernel.segment_sum(vt, st, s)
        want = ref.segment_sum(vt, st, s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if np.issubdtype(dt, np.integer):
            if err != 0:
                raise AssertionError(f"segment_sum {dt.__name__} not exact")
        else:
            # atomics add in another order than the plain version
            rel = 1e-6 if dt == np.float32 else 1e-12
            scale = np.bincount(seg[keep], np.abs(v[keep]).astype(
                np.float64), s)
            diff = (got - want).abs().double().cpu().numpy()
            if not np.all(diff <= rel * scale + 1e-30):
                raise AssertionError(f"segment_sum {dt.__name__} beyond "
                                     f"{rel} * sum|v|")
        ms = time_ms(lambda: kernel.segment_sum(vt, st, s))
        plain = time_ms(lambda: ref.segment_sum(vt, st, s))
        lt = st.long().clamp(0, s - 1)
        lv = torch.where((st >= 0) & (st < s), vt, torch.zeros_like(vt))

        def library():
            torch.zeros(s, dtype=vt.dtype, device=dev).index_add_(0, lt, lv)
        lib = time_ms(library)
        isz = np.dtype(dt).itemsize
        b_ms, b_by = bound(r * (isz + 4) + s * isz, float(r))
        log(f"kernel segment_sum[{np.dtype(dt).name}] R={r} S={s}: "
            f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (index_add_) bound_ms={b_ms:.6f} "
            f"({b_by})")
        rows[np.dtype(dt).name] = {"max_abs_err": err, "ms": ms,
                                   "plain_ms": plain, "library_ms": lib,
                                   "bound_ms": b_ms, "bound_by": b_by}
    head = rows["int32"]
    return {"name": "segment_sum", "route": "cuda",
            "source": ("src/repro_torch/kernels/segment_reduce/csrc/"
                       "segment_reduce.cu"),
            "replaces": "src/repro/kernels/segment_reduce/kernel.py:71",
            **head,
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            "by_dtype": rows}


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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in frames:
            runner.run(f)
        wall = time.perf_counter() - t0
    dev_us = 0.0
    for ev in prof.key_averages():
        dev_us += getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
    busy = dev_us / 1e6 / wall
    log(f"layers (1 thread, profiled): device busy {dev_us / 1e3:.2f} ms "
        f"of {wall * 1e3:.2f} ms wall = {busy:.4f}")
    return {"by_tile": {str(k): v for k, v in out.items()},
            "profiled_wall_ms": wall * 1e3, "device_busy_ms": dev_us / 1e3,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for the measurements JSON and the "
                         "ptxas log")
    out_dir = ap.parse_args().out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.core  # noqa: F401  (fails outside a checkout)
    from repro_torch.core import RefStore
    from repro_torch.core.enrich import queries as Q
    from repro_torch.kernels import (all_kernels, build_all, launch_counts,
                                     reset_launch_counts)

    dev = torch.device("cuda", 0)
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
               check_segment_sum(dev, rng)]
    # phase 4
    t0 = time.perf_counter()
    store = RefStore()
    Q.make_reference_tables(store, scale=1.0, seed=SEED_TABLES)
    log(f"tables: scale 1.0 built in {time.perf_counter() - t0:.1f} s")
    layers = layer_breakdown(dev, store)
    reset_launch_counts()
    feed, split = run_feed(dev, store)
    counts = launch_counts()
    inv, builds = split["invocations"], split["state_builds"]
    # per batch: Q1's probe, Q4's join; per Q6 state build: the income
    # join and the two district group-bys
    want = {"hash_probe": inv + builds, "spatial_join": inv,
            "segment_reduce": 2 * builds}
    log(f"feed: kernel launches {counts} (expected {want})")
    if counts != want or 0 in counts.values():
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
    launches = {"sorted_probe": after["hash_probe"],
                "radius_join": after["spatial_join"],
                "segment_sum": after["segment_reduce"]}

    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = {"kernels": [{kk: k[kk] for kk in keys} for k in kernels]}
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": kernels,
                   "feed": split, "layers": layers,
                   "cross_checked_rows": checked,
                   "query_s": q_s}, fh, indent=1)
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
