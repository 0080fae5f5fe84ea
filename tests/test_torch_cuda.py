"""The port on the card: each hand CUDA kernel against its plain PyTorch
version, the device routing rules, a small feed on the card against the
same feed on the CPU, a 2-layer serve, each model family's serve and
train steps on the card against the CPU.  Every test here is marked
``cuda`` and skips without a CUDA device; this file imports neither jax
nor ``repro``, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.refdata import KEY_SENTINEL
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.hash_probe import kernel as hp_kernel
from repro_torch.kernels.hash_probe import ref as hp_ref
from repro_torch.kernels.segment_reduce import kernel as sr_kernel
from repro_torch.kernels.segment_reduce import ref as sr_ref
from repro_torch.kernels.segment_topk import kernel as st_kernel
from repro_torch.kernels.segment_topk import ref as st_ref
from repro_torch.kernels.spatial_join import kernel as sj_kernel
from repro_torch.kernels.spatial_join import ref as sj_ref

pytestmark = pytest.mark.cuda

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def card():
    """The CUDA device, or a skip: the hand kernels run only on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def on(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def test_sorted_probe_kernel_equals_plain(card):
    rng = np.random.default_rng(1)
    keys = np.full(4096, KEY_SENTINEL, np.int64)
    keys[:4000] = np.sort(rng.choice(40_000, 4000, replace=False))
    keys[10] = keys[11]                       # a duplicate key
    probe = rng.integers(-5, 48_000, 3000).astype(np.int64)
    probe[:5] = KEY_SENTINEL
    p, k = on(probe, card), on(keys, card)
    gi, gf = hp_kernel.sorted_probe(p, k)
    wi, wf = hp_ref.sorted_probe(p, k)
    assert torch.equal(gi, wi) and torch.equal(gf, wf)
    assert gf.any() and not gf[:5].any()


@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_radius_join_kernel_equals_plain_bit_for_bit(card, k):
    rng = np.random.default_rng(k)
    f = np.float32
    px, py = rng.uniform(-10, 10, 700).astype(f), \
        rng.uniform(-10, 10, 700).astype(f)
    rx, ry = rng.uniform(-10, 10, 5000).astype(f), \
        rng.uniform(-10, 10, 5000).astype(f)
    px[:4], py[:4] = rx[:4] + f(2.0), ry[:4]  # on the radius boundary
    rx[100], ry[100] = rx[101], ry[101]       # a distance tie
    valid = on(rng.random(5000) < 0.9, card)
    args = [on(a, card) for a in (px, py, rx, ry)]
    got = sj_kernel.radius_join(*args, 2.0, k, valid)
    want = sj_ref.radius_join(*args, 2.0, k, valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (case, B, R, radius, k): the probe shapes of Q5/Q7 and radius_count,
# references clustered around 8 centres, a radius covering the whole table
# (every pair in radius), probes on the radius and references on cell
# edges, non-finite coordinates, coordinates near 1e6 (float32's ulp past
# the radius: the scan-every-bucket mode), a zero radius, no references
GRID_CASES = [("q5_q7", 6720, 10_240, 3.0, 3), ("q4_count", 6720, 50_176,
                                                1.5, 1),
              ("clustered", 3000, 50_176, 1.5, 8),
              ("whole_table", 500, 5000, 400.0, 8),
              ("boundary", 3000, 4000, 1.5, 8),
              ("nonfinite", 700, 5000, 2.0, 4), ("huge", 300, 2000, 0.04, 4),
              ("zero_radius", 300, 2000, 0.0, 2), ("empty", 40, 0, 1.5, 3),
              ("no_mask", 700, 5000, 2.0, 16)]


def _grid_case(name, b, r, radius, rng):
    layout = name if name in ("clustered", "boundary", "nonfinite",
                              "huge") else "uniform"
    px, py, rx, ry = chip_smoke.spatial_points(layout, rng, b, r, radius)
    if name == "zero_radius":
        px[:50], py[:50] = rx[:50], ry[:50]
    return px, py, rx, ry


@pytest.mark.parametrize("name,b,r,radius,k", GRID_CASES)
def test_radius_join_grid_cases_equal_plain(card, name, b, r, radius, k):
    """The grid join at its edges, bit for bit: idx, d2 bits and count."""
    rng = np.random.default_rng(b + r)
    px, py, rx, ry = _grid_case(name, b, r, radius, rng)
    args = [on(a, card) for a in (px, py, rx, ry)]
    valid = None if name == "no_mask" else on(rng.random(r) < 0.9, card)
    got = sj_kernel.radius_join(*args, radius, k, valid)
    want = sj_ref.radius_join(*args, radius, k, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    if name not in ("empty", "nonfinite"):
        assert int(want[2].sum()) > 0


@pytest.mark.parametrize("b,r,r_valid,offset", [
    (6720, 50_176, 50_000, 0),        # the feed and read path
    (512, 512, 500, 0),               # Q6's income join
    (6720, 1_000_192, 1_000_000, 0),  # Q5's suspicious_names
    (300, 4000, 3990, 1),             # an 8-byte-aligned whole column
    (3, 0, 0, 0), (2, 1, 1, 0)])
def test_sorted_probe_kernel_at_path_shapes(card, b, r, r_valid, offset):
    rng = np.random.default_rng(r)
    keys = np.full(r + offset, KEY_SENTINEL, np.int64)
    keys[offset:offset + r_valid] = np.sort(
        rng.choice(4 * max(r_valid, 1), r_valid, replace=False))
    if r_valid > 20:
        keys[offset + 10:offset + 14] = keys[offset + 10]
    probe = rng.integers(-5, 4 * max(r_valid, 1) + 5, b).astype(np.int64)
    probe[0] = KEY_SENTINEL
    if r_valid:
        probe[1:] = np.where(rng.random(b - 1) < 0.5,
                             keys[offset + rng.integers(0, r_valid, b - 1)],
                             probe[1:])
    p, k = on(probe, card), on(keys, card)[offset:]
    gi, gf = hp_kernel.sorted_probe(p, k)
    wi, wf = hp_ref.sorted_probe(p, k)
    assert torch.equal(gi, wi) and torch.equal(gf, wf)
    assert not gf[0] and (gf.any() or r_valid == 0)


def test_q5_q7_on_card_equal_cpu(card):
    """Q5's and Q7's apply (two radius joins at k = 3, a hash join, group
    counts within the radius) through a ComputingRunner on the card and
    on the CPU over the same tables.  The in-radius group count computes
    |a|^2 + |b|^2 - 2ab as a matrix product, which rounds differently on
    the two devices, so no tweet-reference pair may lie within 0.05 of
    r^2 (then no membership can differ); integer outputs equal."""
    from repro_torch.core import ComputingRunner, ComputingSpec, RefStore
    from repro_torch.core.enrich import queries as Q
    from repro_torch.core.records import SyntheticTweets, parse_json_lines
    store = RefStore()
    Q.make_reference_tables(store, scale=0.02, seed=7)
    batch = parse_json_lines(SyntheticTweets(seed=3).raw_lines(128))
    for table in ("religious_buildings", "facilities"):
        a = store[table].snapshot().arrays
        ok = a["key"] != np.iinfo(np.int64).max
        dx = batch["lat"][:, None].astype(np.float64) - a["lat"][ok][None]
        dy = batch["lon"][:, None].astype(np.float64) - a["lon"][ok][None]
        d = dx * dx + dy * dy
        assert np.abs(d - 9.0).min() > 0.05, table
        assert (d <= 9.0).any(), table
    from repro_torch import kernels
    for udf in (Q.Q5, Q.Q7):
        b = batch["id"].shape[0]
        kernels.reset_launch_counts()
        got = ComputingRunner(ComputingSpec(udf, b), store,
                              device="cuda").run(dict(batch))
        assert kernels.launch_counts()["spatial_join"] == 1
        want = ComputingRunner(ComputingSpec(udf, b), store,
                               device="cpu").run(dict(batch))
        assert set(got) == set(want)
        for key in want:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)


# (case, dtype): 300 uniform segments in every dtype; 6 real groups of
# 2^20 int64 rows (the shared-memory path under contention); 100,000
# segments, a table too large for shared memory (the global-atomic path);
# the count mode through dispatch.segment_count, int64 ids and a mask
SUM_CASES = [("uniform", dt) for dt in (torch.int32, torch.int64,
                                        torch.float32, torch.float64)]
SUM_CASES += [("groups6", torch.int64), ("global", torch.float64),
              ("count", torch.int32)]


@pytest.mark.parametrize("case,dtype", SUM_CASES)
def test_segment_sum_kernel_matches_plain(card, case, dtype):
    from repro_torch.core.enrich import dispatch
    rng = np.random.default_rng(3)
    r, s = {"groups6": (1 << 20, 256), "global": (20_000, 100_000)}.get(
        case, (50_000, 299))
    groups = 6 if case == "groups6" else s + 1
    seg = rng.integers(-1, groups, r).astype(np.int32)
    if case == "count":
        segl = on(seg.astype(np.int64), card)
        valid = on(rng.random(r) < 0.9, card)
        got = dispatch.segment_count(segl, s, valid)
        want = dispatch.segment_count(segl.cpu(), s, valid.cpu())
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
        return
    seg = on(seg, card)
    if dtype.is_floating_point:
        v = on(rng.normal(size=r), card).to(dtype)
    else:
        v = on(rng.integers(-2**20, 2**20, r), card).to(dtype)
    got = sr_kernel.segment_sum(v, seg, s)
    want = sr_ref.segment_sum(v, seg, s)
    assert got.dtype == dtype
    if dtype.is_floating_point:
        # atomics add in another order: 1e-6 (f32) / 1e-12 (f64) of sum|v|
        rel = 1e-6 if dtype == torch.float32 else 1e-12
        scale = sr_ref.segment_sum(v.abs().double(), seg, s)
        assert torch.all((got.double() - want.double()).abs()
                         <= rel * scale + 1e-30)
    else:
        assert torch.equal(got, want)


def _topk_case(name, rng):
    """(values, seg, S) for one segment_topk edge case."""
    r = 20_000
    if name == "one_segment":            # every row in one segment
        return (rng.integers(-3, 9, r).astype(np.int32),
                np.zeros(r, np.int32), 1)
    if name == "all_equal":              # ranks decided by the row alone
        return (np.full(r, 4, np.int32),
                rng.integers(0, 128, r).astype(np.int32), 128)
    if name == "negatives":              # every value ranks as 0
        return (rng.integers(-50, 0, r).astype(np.int32),
                rng.integers(0, 128, r).astype(np.int32), 128)
    if name == "empty_and_dropped":      # empty segments, dropped rows
        seg = rng.integers(-2, 2050, r).astype(np.int32)
        seg[(seg >= 100) & (seg < 200)] = 2048
        return (rng.integers(-1, 6, r).astype(np.int32), seg, 2048)
    if name == "int64":                  # negatives and values past 2^31
        return (rng.integers(-2**40, 2**40, r),
                rng.integers(0, 128, r).astype(np.int32), 128)
    if name == "eager_unit":             # group_by("safety_level"): 2,048
        return (rng.integers(-1, 6, 2048).astype(np.int32),   # rows, 6 of
                rng.integers(0, 6, 2048).astype(np.int32), 128)  # S = 128
    if name == "past_one_pass":          # more rows than the grid buckets
        n = 3_000_000                    # at once: several passes a block
        return (rng.integers(-1, 6, n).astype(np.int32),
                rng.integers(0, 256, n).astype(np.int32), 256)
    if name == "one_big_segment":        # 2^20 rows in one segment
        n = 1 << 20
        return (rng.integers(0, 2**31 - 1, n).astype(np.int32),
                np.zeros(n, np.int32), 1)
    if name == "all_equal_2048":         # S = 2,048, ranks by row alone
        return (np.full(r, 4, np.int32),
                rng.integers(0, 2048, r).astype(np.int32), 2048)
    return (rng.integers(0, 2**31 - 1, r).astype(np.int32),  # "wide"
            rng.integers(0, 2048, r).astype(np.int32), 2048)


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("case", ["one_segment", "all_equal", "negatives",
                                  "empty_and_dropped", "wide", "int64",
                                  "eager_unit", "past_one_pass",
                                  "one_big_segment", "all_equal_2048"])
def test_segment_topk_kernel_equals_plain(card, case, k):
    rng = np.random.default_rng(k)
    vals, seg, s = _topk_case(case, rng)
    v, g = on(vals, card), on(seg, card)
    got = st_kernel.segment_topk_idx(v, g, s, k)
    want = st_ref.segment_topk_idx(v, g, s, k)
    assert got.dtype == torch.int32 and got.shape == (s, k)
    assert torch.equal(got, want)


def test_routing_by_device_on_card(card):
    """CUDA tensors reach the kernels (launch counters grow); segment_topk
    inside its envelope takes its kernel, for 64-bit values too; 64-bit
    sums take the kernel path."""
    from repro_torch import kernels
    from repro_torch.core.enrich import dispatch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    seg = torch.arange(600, device=card, dtype=torch.int32) % 7
    kernels.path_tape_start()
    dispatch.segment_sum(torch.ones(600, dtype=torch.int64, device=card),
                         seg, 7)
    assert kernels.path_tape_stop() == {("segment_sum", "kernel"): 1}
    keys = torch.arange(512, dtype=torch.int64, device=card)
    dispatch.sorted_join(keys, keys)          # below any row threshold
    assert launch_counts() == {"hash_probe": 1, "spatial_join": 0,
                               "segment_reduce": 1, "segment_topk": 0,
                               "flash_attention": 0}
    ids = torch.arange(600, dtype=torch.int64, device=card) * 10
    kernels.path_tape_start()
    pay, val = dispatch.segment_topk(seg - 2, seg, ids, 7, 2)
    assert kernels.path_tape_stop() == {("segment_topk", "kernel"): 1}
    assert launch_counts()["segment_topk"] == 1
    want = dispatch.segment_topk((seg - 2).cpu(), seg.cpu(), ids.cpu(), 7,
                                 2)
    assert torch.equal(pay.cpu(), want[0]) and torch.equal(val.cpu(),
                                                           want[1])
    # int64 values rank clipped to [0, 2^31), as in the plain version, and
    # come back unclipped; the caller's tensor is left as it was
    big = (seg.long() - 3) << 33
    before = big.clone()
    want = dispatch.segment_topk(before.cpu(), seg.cpu(), ids.cpu(), 7, 2)
    kernels.path_tape_start()
    pay, val = dispatch.segment_topk(big, seg, ids, 7, 2)
    assert kernels.path_tape_stop() == {("segment_topk", "kernel"): 1}
    assert launch_counts()["segment_topk"] == 2
    assert torch.equal(big, before)
    assert (want[1] > 2**31 - 1).any() and (want[1] < 0).any()
    assert torch.equal(pay.cpu(), want[0]) and torch.equal(val.cpu(),
                                                           want[1])
    # outside the envelope (float values, k > 16) the composite sort runs
    # on the card and is recorded as such
    kernels.path_tape_start()
    dispatch.segment_topk(seg.float(), seg, seg, 7, 2)
    dispatch.segment_topk(seg, seg, seg, 7, 17)
    assert kernels.path_tape_stop() == {("segment_topk",
                                          "plain_on_card"): 2}
    assert launch_counts()["segment_topk"] == 2


def test_small_feed_on_card_equals_cpu(card):
    from repro_torch.core import FeedManager, RefStore, SyntheticAdapter, \
        pipeline
    from repro_torch.core.enrich import queries as Q
    from repro_torch.core.query import agg
    store = RefStore()
    Q.make_reference_tables(store, scale=0.01, seed=7)

    def run(dev):
        feed = FeedManager(store, device=dev).submit(
            pipeline(SyntheticAdapter(total=1200, frame_size=300, seed=4),
                     f"small-{dev}")
            .parse(batch_size=300).options(num_partitions=2,
                                           coalesce_rows=0)
            .enrich(Q.Q1.then(Q.Q4).then(Q.Q6)).store())
        assert feed.join(timeout=300).stored == 1200
        cols = ["id", "safety_level", "nearby_monuments",
                "nearby_monument_count", "district", "area_avg_income",
                "area_facility_counts", "area_ethnicity_dist"]
        rows = feed.query().select(*cols).execute()
        order = np.argsort(rows["id"])
        res = (feed.query().group_by("country")
               .agg(n=agg.count(), inc=agg.mean("area_avg_income"))
               .execute())
        return {k: v[order] for k, v in rows.items()}, res, feed

    g_rows, g_res, g_feed = run("cuda")
    c_rows, c_res, _ = run("cpu")
    for k in c_rows:
        assert g_rows[k].dtype == c_rows[k].dtype
        np.testing.assert_array_equal(g_rows[k], c_rows[k], err_msg=k)
    np.testing.assert_array_equal(g_res["n"], c_res["n"])
    np.testing.assert_allclose(g_res["inc"], c_res["inc"], rtol=1e-12)
    # top-k ties break by scan order, which follows the order the two
    # workers' batches reached the store: compare on one snapshot
    q = (g_feed.query().group_by("country")
         .agg(top=agg.topk("safety_level", 3, payload="id")))
    storage = g_feed.storage
    with storage.snapshot() as snap:
        on_card = q.execute(snapshot=snap)
        storage.device = torch.device("cpu")
        on_cpu = q.execute(snapshot=snap)
    assert on_card.stats.agg_kernel_dispatches > 0
    assert on_cpu.stats.agg_kernel_dispatches == 0
    np.testing.assert_array_equal(on_card["top"], on_cpu["top"])


# (B, S, T, H, Kv, D, causal): G in {1, 4, 7}; S < T causal is aligned
# top-left; S and T off the wgmma body's 128-row and 64-key tiles, one row
# and one key, non-causal S > T, B = 2 with G = 7
FLASH_CASES = [(2, 300, 300, 8, 8, 64, True), (1, 333, 333, 16, 4, 112, True),
               (1, 200, 200, 14, 2, 128, True), (1, 100, 300, 8, 2, 64, True),
               (1, 200, 520, 14, 2, 128, False), (1, 130, 130, 8, 2, 72, True),
               (3, 1, 1, 4, 4, 16, True), (1, 65, 1, 4, 1, 32, False),
               (1, 1000, 1000, 14, 2, 128, True),
               (1, 1000, 1000, 8, 2, 64, True),
               (1, 1, 1, 7, 1, 128, True), (1, 1, 1, 4, 4, 64, True),
               (1, 100, 300, 14, 2, 128, True),
               (1, 200, 520, 8, 4, 64, False),
               (2, 333, 333, 56, 8, 128, True),
               (2, 257, 129, 14, 2, 64, False),
               # olmoe-1b-7b's prefill: group 1 at D = 128; internvl2-2b's:
               # 256 frontend rows before a 16-token bucket
               (1, 1552, 1552, 16, 16, 128, True),
               (1, 272, 272, 16, 8, 128, True),
               # whisper-medium's: the encoder (S = T = 1,536 frames,
               # non-causal, G = 1 at D = 64), the cross-attention of its
               # longest prompt, and a decode step's over 4 slots (S = 1)
               (1, 1536, 1536, 16, 16, 64, False),
               (1, 448, 1536, 16, 16, 64, False),
               (4, 1, 1536, 16, 16, 64, False)]
# the body each bf16 head dim of FLASH_CASES takes; float32 takes the
# CUDA-core body at every D
BF16_BODY = {64: "wgmma", 128: "wgmma", 16: "mma_sync", 32: "mma_sync",
             112: "mma_sync", 72: "cuda_core"}


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("b,s,t,h,kv,d,causal", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(card, dtype, tol, b, s, t, h,
                                              kv, d, causal):
    want_body = BF16_BODY[d] if dtype == torch.bfloat16 else "cuda_core"
    assert fa_kernel.body(dtype, d) == want_body
    g = torch.Generator(device=card).manual_seed(s * t + d)
    q = torch.randn(b, s, h, d, generator=g, device=card).to(dtype)
    k = torch.randn(b, t, kv, d, generator=g, device=card).to(dtype)
    v = torch.randn(b, t, kv, d, generator=g, device=card).to(dtype)
    got = fa_kernel.flash_attention(q, k, v, causal)
    want = fa_ref.flash_attention(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_body_takes_noncontiguous_views(card, d):
    """q sliced out of a wider last dim and k a transposed (B, Kv, T, D)
    tensor go to TMA in place; v with a strided D is copied first."""
    g = torch.Generator(device=card).manual_seed(d)
    q = torch.randn(2, 300, 14, d + 64, generator=g,
                    device=card).bfloat16()[..., :d]
    k = torch.randn(2, 2, 300, d, generator=g,
                    device=card).bfloat16().transpose(1, 2)
    v = torch.randn(2, 300, 2, 2 * d, generator=g,
                    device=card).bfloat16()[..., ::2]
    assert not (q.is_contiguous() or k.is_contiguous()
                or v.is_contiguous())
    got = fa_kernel.flash_attention(q, k, v, True)
    want = fa_ref.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_serving_shape_takes_wgmma_and_counts(card):
    """deepseek-coder-33b's 1,536-token prefill attention: the wgmma body,
    one launch per call through ops, within 2e-2 of the plain version."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa_ops
    g = torch.Generator(device=card).manual_seed(1536)
    q = torch.randn(1, 1536, 56, 128, generator=g, device=card).bfloat16()
    k, v = (torch.randn(1, 1536, 8, 128, generator=g, device=card).bfloat16()
            for _ in range(2))
    assert fa_kernel.body(q.dtype, q.shape[-1]) == "wgmma"
    reset_launch_counts()
    got = fa_ops.flash_attention(q, k, v, True)
    assert launch_counts()["flash_attention"] == 1
    want = fa_ref.flash_attention(q, k, v, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_attention_routing_on_card(card):
    """ops and the model's _sdpa reach the kernel; packed segments run the
    plain version, recorded as "plain_on_card"; the wrapper refuses what
    the kernel does not take."""
    from repro_torch.configs import smoke_config
    from repro_torch import kernels
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers as L
    cfg = smoke_config("deepseek-coder-33b")
    q = torch.randn(1, 24, 4, 16, device=card)
    kv = torch.randn(1, 24, 2, 16, device=card)
    reset_launch_counts()
    kernels.reset_path_stats()
    fa_ops.flash_attention(q, kv, kv)
    L._sdpa(cfg, q, kv, kv, None, None, None, None, True)
    assert launch_counts()["flash_attention"] == 2
    seg = torch.ones(1, 24, dtype=torch.int32, device=card)
    L._sdpa(cfg, q, kv, kv, None, None, seg, seg, True)
    assert launch_counts()["flash_attention"] == 2
    assert kernels.path_stats() == {("flash_attention", "plain_on_card"): 1}
    with pytest.raises(TypeError):
        fa_kernel.flash_attention(q.half(), kv.half(), kv.half())
    big = torch.randn(1, 4, 2, 160, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel.flash_attention(big, big, big)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_layer_serve_on_card_matches_cpu(card, dtype):
    """The smoke deepseek-coder-33b (2 layers) served on the card and on
    the CPU from the same parameters: equal tokens in float32.  In bf16
    the two devices round at other places and this model's attention is
    sharp, so single logits move by up to ~0.1 std; the test holds the
    rms of the difference.  scripts/serve_logit_spread.py measured this
    config's apply over these prompts on an H100 (3 parameter seeds,
    seed 0 is this test's): rms/std at most 0.0153 sound, at least
    1.0882 (a trial's largest) with the query heads in the wrong GQA
    order.  The limit lies between the two."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import api
    from repro_torch.models.params import tree_map
    from repro_torch.serve import Request, ServingEngine
    cfg = smoke_config("deepseek-coder-33b").replace(
        dtype=dtype, head_dim=64 if dtype == "bfloat16" else 16)
    params = api.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    cpu_params = tree_map(lambda x: x.cpu(), params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(16, cfg.vocab_size, n).tolist()
               for n in (8, 19, 33)]
    if dtype == "float32":
        reset_launch_counts()
        out = {}
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            eng = ServingEngine(cfg, p, slots=2, max_len=96, device=dev)
            reqs = [eng.submit(Request(list(x), max_new_tokens=6,
                                       stop_at_eos=False)) for x in prompts]
            eng.run()
            out[dev] = [r.tokens for r in reqs]
        assert out["cuda"] == out["cpu"]
        # prefill and first-token apply, each layer, each request
        assert launch_counts()["flash_attention"] == 2 * 2 * 3
        return
    for prompt in prompts:
        tok = torch.tensor([prompt], dtype=torch.int32)
        got, _ = api.apply(cfg, params, {"tokens": tok.to(card)})
        want, _ = api.apply(cfg, cpu_params, {"tokens": tok})
        rms = (got.cpu() - want).pow(2).mean().sqrt() / want.std()
        assert float(rms) < 0.1


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-130m",
                                  "internvl2-2b", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_family_serves_on_card_like_cpu(card, arch):
    """Each ported family at smoke widths (float32) served on the card and
    on the CPU from the same parameters: equal tokens, the first-token
    logits within float32 rounding (whisper's over seeded random frames),
    and the flash kernel in every attention layer of every prefill and
    first-token apply (none for the ssm family; whisper's encoder, self-
    and cross-attention layers, and its cross-attention in every decode
    step), no attention on the plain version."""
    from repro_torch import kernels
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import api
    from repro_torch.models.params import tree_map
    from repro_torch.serve import Request, ServingEngine
    cfg = smoke_config(arch)
    params = api.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    cpu_params = tree_map(lambda x: x.cpu(), params)
    rng = np.random.default_rng(5)
    # whole chunks of 8 for the SSD families
    prompts = [rng.integers(16, cfg.vocab_size, n).tolist()
               for n in (8, 16, 24)]
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        reset_launch_counts()
        kernels.reset_path_stats()
        eng = ServingEngine(cfg, p, slots=2, max_len=64, device=dev)
        reqs = [eng.submit(Request(list(x), max_new_tokens=6,
                                   stop_at_eos=False)) for x in prompts]
        eng.run()
        out[dev] = [r.tokens for r in reqs]
        if dev == "cuda":
            attn = (0 if cfg.family == "ssm" else cfg.num_layers
                    // cfg.attn_period if cfg.family == "hybrid"
                    else cfg.encoder_layers + 2 * cfg.num_layers
                    if cfg.family == "encdec" else cfg.num_layers)
            per_step = cfg.num_layers if cfg.family == "encdec" else 0
            assert launch_counts()["flash_attention"] == \
                2 * attn * len(prompts) + per_step * eng.decode_steps
            assert ("flash_attention", "plain_on_card") not in \
                kernels.path_stats()
    assert out["cuda"] == out["cpu"]
    batch = {"tokens": torch.tensor([prompts[1]], dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frontend"] = torch.from_numpy(rng.normal(size=(
            1, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32))
    got, _ = api.apply(cfg, params, {k: v.to(card) for k, v in
                                     batch.items()})
    want, _ = api.apply(cfg, cpu_params, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# (B, S, capacity_factor): the global layout (B*S <= 4096) and the
# per-row one (B*S > 4096), each at a factor small enough that pairs drop
@pytest.mark.parametrize("b,s,cf", [(2, 24, 0.3), (2, 2056, 0.4)])
def test_moe_routing_on_card_equals_cpu(card, b, s, cf):
    """The MoE routing on the card from the same router logits as the CPU,
    a fifth of the rows zeroed so their logits tie exactly: the stable
    sorts must give the CPU's experts, grouping order and kept masks bit
    for bit; the FFN's output agrees within float32 rounding."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import api
    from repro_torch.models import moe as M
    cfg = smoke_config("olmoe-1b-7b").replace(capacity_factor=cf)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    g = torch.Generator().manual_seed(s)
    x = torch.randn(b, s, cfg.d_model, generator=g)
    x[:, ::5] = 0.0
    logits = torch.matmul(x, p["router"])
    cap = M._capacity(cfg, b * s if b * s <= 4096 else s)
    got, want = {}, {}
    for dev, out in (("cuda", got), ("cpu", want)):
        w, idx = M._route(logits.to(dev), cfg.experts_per_token)
        groups = idx.reshape(1, b * s, -1) if b * s <= 4096 else idx
        out["idx"] = idx.cpu()
        out["slots"] = [a.cpu() for a in M.expert_slots(
            groups, cfg.num_experts, cap)]
        pd = {k: v.to(dev) for k, v in p.items()}
        out["y"], out["aux"] = (a.cpu() for a in M.moe_ffn(cfg, pd,
                                                           x.to(dev)))
    assert torch.equal(got["idx"], want["idx"])
    for a, c in zip(got["slots"], want["slots"]):
        assert torch.equal(a, c)
    assert not bool(want["slots"][1].all())          # pairs were dropped
    torch.testing.assert_close(got["y"], want["y"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got["aux"], want["aux"], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

# Card against CPU after one train step from the same state
# (chip_smoke.train_check_readings: |d loss|, |d grad_norm| / grad_norm,
# the worst leaf's |d update| / |update|).  float32: the two devices sum
# in other orders (TF32 off), limits far above that rounding.  bf16:
# scripts/train_step_spread.py measured this config on an H100 (3 seeds,
# seed 0 is this test's): sound at most 4.3e-6, 8.1e-5 and 0.0937; with
# the attention output detached each trial's grad_norm at least 0.892 and
# update 43.2; with the segment mask dropped at least 0.0050, 0.544 and
# 1.52.  The limits lie between the two.
TRAIN_TEST_TOL = {"float32": {"loss": 1e-4, "grad_norm": 1e-4,
                              "update": 1e-2},
                  "bfloat16": {"loss": 1e-3, "grad_norm": 0.05,
                               "update": 0.5}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_card_matches_cpu(card, dtype):
    """The smoke deepseek-coder-33b (2 layers, remat "full") one step on a
    packed row of 256 tokens (chunked attention) on the card and on the
    CPU from the same state: loss, grad_norm and every updated leaf.  No
    kernel launches; every attention is the plain chunked version."""
    from repro_torch import kernels
    from repro_torch.configs import smoke_config
    cfg = smoke_config("deepseek-coder-33b").replace(
        remat="full", dtype=dtype, param_dtype=dtype)
    kernels.reset_launch_counts()
    kernels.reset_path_stats()
    r, _ = chip_smoke.train_check_readings(card, chip_smoke.packed_row(256), 0,
                                           cfg=cfg)
    assert not any(kernels.launch_counts().values())
    assert kernels.path_stats()[("flash_attention", "plain_on_card")] == \
        2 * cfg.num_layers
    tol = TRAIN_TEST_TOL[dtype]
    assert all(r[k] <= tol[k] for k in tol), r


def test_every_gradient_leaf_non_zero_on_card(card):
    """bf16 at full head_dim 128: the first batch's gradient is finite and
    non-zero in every leaf (a detached attention would zero wq, wk and
    wv), and equals the CPU's to bf16's rounding."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.params import tree_flatten, tree_map
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.steps import init_train_state
    cfg = smoke_config("deepseek-coder-33b").replace(
        remat="full", dtype="bfloat16", param_dtype="bfloat16", head_dim=128)
    st = init_train_state(cfg, OptConfig(),
                          torch.Generator(device=card).manual_seed(1))
    step = make_train_step(cfg, OptConfig())
    row = chip_smoke.packed_row(512, seed=1)
    _, _, grads = step.accumulate(st["params"], row)
    chip_smoke.check_grads(grads)
    _, _, cpu_grads = step.accumulate(
        tree_map(lambda x: x.cpu(), st["params"]), row)
    for g, c in zip(tree_flatten(grads)[0], tree_flatten(cpu_grads)[0]):
        rel = (torch.linalg.vector_norm(g.float().cpu() - c.float())
               / torch.linalg.vector_norm(c.float()))
        assert float(rel) < 0.1


def test_trainer_restarts_on_card(card, tmp_path):
    from repro_torch.ckpt import latest_step
    from repro_torch.configs import smoke_config
    from repro_torch.train import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = smoke_config("deepseek-coder-33b")
    tcfg = TrainerConfig(steps=8, ckpt_dir=str(tmp_path), ckpt_every=3,
                         log_every=1, max_restarts=1)
    trainer = Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=1), tcfg,
                      device=card)
    seen = []

    def fault_hook(step):
        seen.append(step)
        if step == 4 and seen.count(4) == 1:
            raise RuntimeError("injected failure")
    rng = np.random.default_rng(0)
    batches = ({"tokens": t, "targets": np.roll(t, -1, 1)} for t in (
        rng.integers(3, cfg.vocab_size, (2, 32)).astype(np.int32)
        for _ in range(50)))
    hist = trainer.run(batches, fault_hook=fault_hook)
    assert trainer.restarts == 1 and int(trainer.state["step"]) == 8
    assert seen == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    assert trainer.state["params"]["embed"]["tok"].is_cuda
    assert latest_step(str(tmp_path)) == 8
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_lm_data_plane_feeds_the_trainer_on_card(card):
    """UDF2 -> tokenize -> filter -> packer on the card feeds 5 steps."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import FeedManager, RefStore
    from repro_torch.core.enrich import queries as Q
    from repro_torch.train import OptConfig
    from repro_torch.train.data_feed import FeedDataSource
    from repro_torch.train.trainer import Trainer, TrainerConfig
    store = RefStore()
    Q.make_reference_tables(store, scale=0.01, seed=7)
    cfg = smoke_config("deepseek-coder-33b")
    src = FeedDataSource(FeedManager(store, device=card),
                         vocab_size=cfg.vocab_size, seq_len=256,
                         batch_size=2, total_records=4000, frame_size=512,
                         safety_filter=True, num_partitions=2)
    trainer = Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=1),
                      TrainerConfig(steps=5, log_every=1), device=card)
    try:
        hist = trainer.run(iter(src))
    finally:
        src.close()
    assert int(trainer.state["step"]) == 5 and len(hist) == 5
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert src.filtered >= 0 and len(trainer.step_times) == 5


def test_flash_kernel_refuses_inputs_that_require_grad(card):
    q = torch.randn(1, 64, 4, 16, device=card, requires_grad=True)
    kv = torch.randn(1, 64, 2, 16, device=card)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="forward-only"):
        fa_kernel.flash_attention(q, kv, kv)
    assert launch_counts()["flash_attention"] == 0
    with torch.no_grad():
        out = fa_kernel.flash_attention(q, kv, kv)
    assert not out.requires_grad and launch_counts()["flash_attention"] == 1


# ---------------------------------------------------------------------------
# the rest of the workload, and a durable feed, on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables_1x():
    """make_reference_tables(scale=1.0, seed=7): the paper's cardinalities
    (50,000 countries, 10,000 sensitive words, 1,000,000 names)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    from repro_torch.core import RefStore
    from repro_torch.core.enrich import queries as Q
    store = RefStore()
    Q.make_reference_tables(store, scale=1.0, seed=7)
    return store


# per UDF at one 6,720-tweet batch: (hash_probe, spatial_join,
# segment_reduce) launches and the dispatch paths recorded.  Q3's top-3
# over 50,000 countries is outside segment_topk's envelope (at most 2,048
# segments): the composite sort runs on the card, recorded as such
WORKLOAD_ON_CARD = {
    "q2": ((0, 0, 1), {("segment_sum", "kernel"): 1}),
    "q3": ((0, 0, 0), {("segment_topk", "plain_on_card"): 1}),
    "udf1": ((0, 0, 0), {}),
    "udf2": ((0, 0, 0), {}),
    "q5": ((1, 1, 0), {}),
    "q7": ((0, 1, 0), {}),
}


@pytest.mark.parametrize("udf", sorted(WORKLOAD_ON_CARD))
def test_workload_udf_on_card_equals_cpu_at_scale_1(card, tables_1x, udf):
    """One batch of 6,720 tweets through a ComputingRunner on the card and
    on the CPU over the scale-1.0 tables: every output column equal, with
    dtypes and shapes, and the kernels launched as the path requires (no
    segment_topk or flash launch anywhere)."""
    from repro_torch import kernels
    from repro_torch.core import ComputingRunner, ComputingSpec
    from repro_torch.core.enrich import queries as Q
    from repro_torch.core.records import SyntheticTweets, parse_json_lines
    batch = parse_json_lines(SyntheticTweets(seed=3).raw_lines(6720))
    u = Q.get_udf(udf)
    kernels.reset_launch_counts()
    kernels.path_tape_start()
    got = ComputingRunner(ComputingSpec(u, 6720), tables_1x,
                          device=card).run(dict(batch))
    paths = kernels.path_tape_stop()
    counts = kernels.launch_counts()
    want = ComputingRunner(ComputingSpec(u, 6720), tables_1x,
                           device="cpu").run(dict(batch))
    launches, want_paths = WORKLOAD_ON_CARD[udf]
    assert (counts["hash_probe"], counts["spatial_join"],
            counts["segment_reduce"]) == launches
    assert counts["segment_topk"] == counts["flash_attention"] == 0
    assert {p: n for p, n in paths.items()
            if p[0] in ("segment_sum", "segment_topk")} == want_paths
    assert set(got) == set(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    if udf == "q2":
        assert got["religious_population"].dtype == np.int64
        assert (got["religious_population"] > 0).any()
    if udf == "udf2":
        assert got["safety_check_flag"].any()


def test_q5_counts_equal_cpu_with_tf32_on(card, tables_1x):
    """Q5 with the process-wide TF32 flag on (as the trainer sets it):
    its facility counts decide ``d2 <= r2`` on |a|^2 + |b|^2 - 2ab, whose
    cross term the card computes without cuBLAS, so the flag cannot
    round it; every row of ``nearby_facility_counts`` (and every other
    column) equals the CPU's at one 6,720-tweet batch of the scale-1.0
    tables."""
    from repro_torch.core import ComputingRunner, ComputingSpec
    from repro_torch.core.enrich import queries as Q
    from repro_torch.core.records import SyntheticTweets, parse_json_lines
    batch = parse_json_lines(SyntheticTweets(seed=5).raw_lines(6720))
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = ComputingRunner(ComputingSpec(Q.Q5, 6720), tables_1x,
                              device=card).run(dict(batch))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    want = ComputingRunner(ComputingSpec(Q.Q5, 6720), tables_1x,
                           device="cpu").run(dict(batch))
    assert got["nearby_facility_counts"].shape[0] == 6720
    assert np.asarray(want["nearby_facility_counts"]).any()
    assert set(got) == set(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def copy_crash_image(src, dst):
    """Copy a live durable dir in crash-causal order: checkpoints, then
    store manifests, then data files (WAL and npz segments), so metadata
    never points at data older than itself.  Files may vanish mid-walk."""
    import os
    import shutil
    paths = []
    for root, _, names in os.walk(src):
        for n in names:
            if n.endswith(".tmp"):
                continue
            rank = (0 if n.startswith("CHECKPOINT") else
                    1 if n.startswith("MANIFEST") else 2)
            paths.append((rank, os.path.join(root, n)))
    for _, p in sorted(paths):
        out = os.path.join(dst, os.path.relpath(p, src))
        os.makedirs(os.path.dirname(out), exist_ok=True)
        try:
            shutil.copyfile(p, out)
        except FileNotFoundError:
            continue


def test_durable_crash_image_resumes_on_card(card, tmp_path):
    """An image of a durable Q1 > Q2 > Q3 feed on the card, copied while it
    runs, resumes on the card exactly once; a second copy resumed on the
    CPU stores the same rows by id."""
    import shutil
    import time
    from repro_torch.core import (DurableSpec, FeedManager, RefStore,
                                  SyntheticAdapter, pipeline)
    from repro_torch.core.enrich import queries as Q
    store = RefStore()
    Q.make_reference_tables(store, scale=0.02, seed=7)
    total = 4000

    def plan(d, rate=None):
        return (pipeline(SyntheticAdapter(total=total, frame_size=200,
                                          seed=3, rate=rate), "dur")
                .parse(batch_size=200).options(num_partitions=2)
                .enrich(Q.Q1.then(Q.Q2).then(Q.Q3))
                .store(durable=DurableSpec(dir=str(d),
                                           checkpoint_interval_s=0.1,
                                           fsync_interval_s=0.02)))

    live = tmp_path / "live"
    h = FeedManager(store, device=card).submit(plan(live, rate=4000.0))
    time.sleep(0.5)
    image = tmp_path / "image"
    copy_crash_image(str(live), str(image))
    assert h.join(timeout=120).stored == total
    rows = {}
    for dev in ("cuda", "cpu"):
        mine = tmp_path / dev
        shutil.copytree(image, mine)
        r = FeedManager(store, device=dev).resume(plan(live),
                                                  durable_dir=str(mine))
        assert r.durability.recovered
        r.join(timeout=120)
        got = r.query().select("id", "safety_level", "religious_population",
                               "largest_religions").execute()
        ids = np.asarray(got["id"])
        assert len(ids) == total and set(ids.tolist()) == set(range(total))
        order = np.argsort(ids)
        rows[dev] = {k: np.asarray(v)[order] for k, v in got.items()}
    for k in rows["cpu"]:
        assert rows["cuda"][k].dtype == rows["cpu"][k].dtype, k
        np.testing.assert_array_equal(rows["cuda"][k], rows["cpu"][k],
                                      err_msg=k)


def test_stand_in_tensors_take_the_plain_version_on_card(card):
    """A real CUDA tensor launches the flash kernel; a FakeTensor on the
    card (the dry run's stand-ins) takes the plain version and launches
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention import ops as fa_ops
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(1, 128, 8, 64, generator=g, device=card,
                    dtype=torch.bfloat16)
    k = torch.randn(1, 128, 2, 64, generator=g, device=card,
                    dtype=torch.bfloat16)
    before = fa_kernel.KERNEL.launches
    fa_ops.flash_attention(q, k, k, True)
    assert fa_kernel.KERNEL.launches == before + 1
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fq, fk = fm.from_tensor(q), fm.from_tensor(k)
        out = fa_ops.flash_attention(fq, fk, fk, True)
    assert out.shape == q.shape and out.device.type == "cuda"
    assert fa_kernel.KERNEL.launches == before + 1


def test_dtensor_over_card_shards_never_takes_the_plain_version(
        card, monkeypatch):
    """A DTensor over real CUDA shards (a 1-rank NCCL mesh) is routed to
    the flash kernel's path, whose operand check refuses it: it neither
    launches on a DTensor nor falls back to the plain version.  Its local
    shard launches the kernel."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import on_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops

    def refuse(*a, **k):
        raise AssertionError("a DTensor on the card took the plain version")
    monkeypatch.setattr(fa_ops.ref, "flash_attention", refuse)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        g = torch.Generator(device=card).manual_seed(0)
        q = torch.randn(1, 128, 8, 64, generator=g, device=card,
                        dtype=torch.bfloat16)
        k = torch.randn(1, 128, 2, 64, generator=g, device=card,
                        dtype=torch.bfloat16)
        dq, dk = (distribute_tensor(x, mesh, [Replicate()]) for x in (q, k))
        assert on_cuda(dq)
        before = fa_kernel.KERNEL.launches
        with pytest.raises(TypeError, match="local shard"):
            fa_ops.flash_attention(dq, dk, dk, True)
        assert fa_kernel.KERNEL.launches == before
        out = fa_ops.flash_attention(dq.to_local(), dk.to_local(),
                                     dk.to_local(), True)
        assert fa_kernel.KERNEL.launches == before + 1
        assert out.shape == q.shape
    finally:
        dist.destroy_process_group()
