"""The port on the card: each hand CUDA kernel against its plain PyTorch
version, the device routing rules, and a small feed on the card against
the same feed on the CPU.  Every test here is marked ``cuda`` and skips
without a CUDA device; this file imports neither jax nor ``repro``, so it
runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.refdata import KEY_SENTINEL
from repro_torch.kernels.hash_probe import kernel as hp_kernel
from repro_torch.kernels.hash_probe import ref as hp_ref
from repro_torch.kernels.segment_reduce import kernel as sr_kernel
from repro_torch.kernels.segment_reduce import ref as sr_ref
from repro_torch.kernels.segment_topk import kernel as st_kernel
from repro_torch.kernels.segment_topk import ref as st_ref
from repro_torch.kernels.spatial_join import kernel as sj_kernel
from repro_torch.kernels.spatial_join import ref as sj_ref

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64,
                                   torch.float32, torch.float64])
def test_segment_sum_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(3)
    seg = on(rng.integers(-1, 300, 50_000).astype(np.int32), card)
    if dtype.is_floating_point:
        v = on(rng.normal(size=50_000), card).to(dtype)
    else:
        v = on(rng.integers(-2**20, 2**20, 50_000), card).to(dtype)
    got = sr_kernel.segment_sum(v, seg, 299)
    want = sr_ref.segment_sum(v, seg, 299)
    assert got.dtype == dtype
    if dtype.is_floating_point:
        # atomics add in another order: 1e-6 (f32) / 1e-12 (f64) of sum|v|
        rel = 1e-6 if dtype == torch.float32 else 1e-12
        scale = sr_ref.segment_sum(v.abs().double(), seg, 299)
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
    return (rng.integers(0, 2**31 - 1, r).astype(np.int32),  # "wide"
            rng.integers(0, 2048, r).astype(np.int32), 2048)


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("case", ["one_segment", "all_equal", "negatives",
                                  "empty_and_dropped", "wide", "int64"])
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
    from repro_torch.core.enrich import dispatch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    seg = torch.arange(600, device=card, dtype=torch.int32) % 7
    dispatch.path_tape_start()
    dispatch.segment_sum(torch.ones(600, dtype=torch.int64, device=card),
                         seg, 7)
    assert dispatch.path_tape_stop() == {("segment_sum", "kernel"): 1}
    keys = torch.arange(512, dtype=torch.int64, device=card)
    dispatch.sorted_join(keys, keys)          # below any row threshold
    assert launch_counts() == {"hash_probe": 1, "spatial_join": 0,
                               "segment_reduce": 1, "segment_topk": 0}
    ids = torch.arange(600, dtype=torch.int64, device=card) * 10
    dispatch.path_tape_start()
    pay, val = dispatch.segment_topk(seg - 2, seg, ids, 7, 2)
    assert dispatch.path_tape_stop() == {("segment_topk", "kernel"): 1}
    assert launch_counts()["segment_topk"] == 1
    want = dispatch.segment_topk((seg - 2).cpu(), seg.cpu(), ids.cpu(), 7,
                                 2)
    assert torch.equal(pay.cpu(), want[0]) and torch.equal(val.cpu(),
                                                           want[1])
    # int64 values rank clipped to [0, 2^31), as in the plain version
    big = (seg.long() - 3) << 33
    dispatch.path_tape_start()
    pay, val = dispatch.segment_topk(big, seg, ids, 7, 2)
    assert dispatch.path_tape_stop() == {("segment_topk", "kernel"): 1}
    assert launch_counts()["segment_topk"] == 2
    want = dispatch.segment_topk(big.cpu(), seg.cpu(), ids.cpu(), 7, 2)
    assert torch.equal(pay.cpu(), want[0]) and torch.equal(val.cpu(),
                                                           want[1])
    # outside the envelope (float values, k > 16) the composite sort runs
    # on the card and is recorded as such
    dispatch.path_tape_start()
    dispatch.segment_topk(seg.float(), seg, seg, 7, 2)
    dispatch.segment_topk(seg, seg, seg, 7, 17)
    assert dispatch.path_tape_stop() == {("segment_topk",
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
