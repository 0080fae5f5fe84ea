"""The spatial-grid join and the many-lane sorted probe as designed for
Hopper, on the CPU: the plan the spatial wrapper computes in Python, the
constants both kernels share with these models against the CUDA sources,
the wrappers' refusals outside their envelope (checked before the device,
so they raise here), and numpy models of both kernels' algorithms (the
cell function, the bucket hash, the own-cell rule, the scan-every-bucket
mode, the (d2, index) order; the probe's rounds of evenly spread reads)
held bit for bit to the plain versions, which are the dense functions.
tests/test_torch_cuda.py holds the kernels themselves to their plain
versions on the card."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.hash_probe import ref as r_hp_ref
from repro.kernels.spatial_join import ref as r_sj_ref
from repro_torch.core.refdata import KEY_SENTINEL
from repro_torch.kernels.hash_probe import kernel as hp_kernel
from repro_torch.kernels.hash_probe import ref as hp_ref
from repro_torch.kernels.spatial_join import kernel as sj_kernel
from repro_torch.kernels.spatial_join import ref as sj_ref

F = np.float32

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _define(source, name):
    m = re.search(rf"#define {name} (\S+)", source)
    assert m, name
    return m.group(1)


SJ_SRC = sj_kernel.KERNEL.source.read_text()
HP_SRC = hp_kernel.KERNEL.source.read_text()
GROUP = int(_define(SJ_SRC, "GROUP"))           # lanes (and cells) a probe
PROBE_LANES = int(_define(HP_SRC, "PROBE_LANES"))


# ---------------------------------------------------------------------------
# a numpy model of csrc/spatial_join.cu
# ---------------------------------------------------------------------------

def cell_of(v, inv):
    """The kernel's cell function: floor(fl(v * inv)), clamped to int32."""
    with np.errstate(over="ignore", invalid="ignore"):
        f = np.floor(np.asarray(v, F) * F(inv))
    return np.clip(f, -2.0**31, 2147483520.0).astype(np.int64)


def bucket_of(cx, cy, nb):
    ux = np.atleast_1d(np.asarray(cx).astype(np.uint32))
    uy = np.atleast_1d(np.asarray(cy).astype(np.uint32))
    h = ux * np.uint32(0x9E3779B1) + uy * np.uint32(0x7FEB352D)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    out = (h & np.uint32(nb - 1)).astype(np.int64)
    return out if np.ndim(cx) else int(out[0])


def dist2(qx, qy, x, y):
    """d2 with each operation rounded to float32, as the kernel."""
    dx = F(qx) - np.asarray(x, F)
    dy = F(qy) - np.asarray(y, F)
    with np.errstate(over="ignore", invalid="ignore"):
        return dx * dx + dy * dy


def visited_cells(qx, qy, plan):
    """The probe's box of cells, g-th cell at (x0 + g % nx, y0 + g // nx),
    or None where the box spans more than GROUP cells."""
    rw, inv = F(plan.radius_w), plan.inv_cell
    x0, x1 = cell_of(F(qx) - rw, inv), cell_of(F(qx) + rw, inv)
    y0, y1 = cell_of(F(qy) - rw, inv), cell_of(F(qy) + rw, inv)
    nx, ny = int(x1 - x0 + 1), int(y1 - y0 + 1)
    if nx * ny > GROUP:
        return None
    g = np.arange(nx * ny)
    return x0 + g % nx, y0 + g // nx


def grid_model(px, py, rx, ry, radius, k, valid=None, seed=0):
    """The kernel's algorithm on the host: bin (buckets in any order
    inside, as the atomics leave them), visit each probe's cells, accept
    only own-cell points, scan every bucket past GROUP cells or where the
    cells' buckets hold the table's size or more, rank by (d2, index).
    Returns (idx, dist2, count, probes that scanned every bucket)."""
    b, r = px.shape[0], rx.shape[0]
    plan = sj_kernel.grid_plan(r, radius)
    nb, inv, r2 = plan.buckets, plan.inv_cell, F(plan.r2)
    ok = np.isfinite(rx) & np.isfinite(ry)
    if valid is not None:
        ok &= valid
    cx, cy = cell_of(rx, inv), cell_of(ry, inv)
    bk = bucket_of(cx, cy, nb)
    rows = np.flatnonzero(ok)
    rows = rows[np.random.default_rng(seed).permutation(rows.size)]
    rows = rows[np.argsort(bk[rows], kind="stable")]   # the scatter
    starts = np.searchsorted(bk[rows], np.arange(nb + 1))
    nvalid = rows.size
    idx = np.full((b, k), -1, np.int32)
    d2 = np.full((b, k), np.inf, F)
    count = np.zeros(b, np.int32)
    scanned_all = 0
    for q in range(b):
        if not (np.isfinite(px[q]) and np.isfinite(py[q])):
            continue
        cells = visited_cells(px[q], py[q], plan)
        cand = None
        if cells is not None:
            parts = []
            for gx, gy in zip(*cells):
                bb = bucket_of(gx, gy, nb)
                inb = rows[starts[bb]:starts[bb + 1]]
                parts.append(inb[(cx[inb] == gx) & (cy[inb] == gy)])
            total = sum(starts[bucket_of(gx, gy, nb) + 1]
                        - starts[bucket_of(gx, gy, nb)]
                        for gx, gy in zip(*cells))
            if total < nvalid:
                cand = np.concatenate(parts) if parts else rows[:0]
        if cand is None:
            scanned_all += 1
            cand = rows
        d = dist2(px[q], py[q], rx[cand], ry[cand])
        hit = d <= r2
        count[q] = int(hit.sum())
        hc, hd = cand[hit], d[hit]
        order = np.lexsort((hc, hd))[:k]
        idx[q, :order.size] = hc[order]
        d2[q, :order.size] = hd[order]
    return idx, d2, count, scanned_all


def _uniform(rng, b, r, lo=(-60, -180), hi=(60, 180)):
    return chip_smoke.spatial_points("uniform", rng, b, r, 0.0, lo, hi)


def _boundary(rng, b, r, radius):
    """chip_smoke's boundary layout over [-8, 8]^2, dense enough at these
    sizes for probes to meet points of other cells."""
    return chip_smoke.spatial_points("boundary", rng, b, r, radius,
                                     (-8, -8), (8, 8))


# (case, probes, rows, radius, k): Q4's and Q5/Q7's radii and k, the k = 1
# of radius_count, a radius covering the whole table, a zero radius
MODEL_CASES = [
    ("uniform", 120, 3000, 1.5, 8), ("uniform", 120, 3000, 1.5, 1),
    ("uniform", 120, 1000, 3.0, 3), ("uniform", 60, 500, 400.0, 16),
    ("clustered", 120, 3000, 1.5, 8), ("clustered", 80, 2000, 3.0, 3),
    ("boundary", 200, 300, 1.5, 8), ("boundary", 200, 300, 3.0, 3),
    ("boundary", 100, 200, 0.75, 2), ("nonfinite", 50, 400, 2.0, 4),
    ("huge", 40, 200, 0.04, 4), ("uniform", 30, 300, 0.0, 2),
]


def _case(name, b, r, radius, seed):
    rng = np.random.default_rng(seed)
    if name == "boundary":
        return _boundary(rng, b, r, radius)
    box = ((-5, -5), (5, 5)) if name == "nonfinite" else \
        ((-60, -180), (60, 180))
    return chip_smoke.spatial_points(name, rng, b, r, radius, *box)


@pytest.mark.parametrize("name,b,r,radius,k", MODEL_CASES)
def test_grid_model_equals_dense_plain_version(name, b, r, radius, k):
    """The model of the grid kernel gives the dense plain version's idx,
    d2 bits and count, with 10 % of the rows invalid."""
    px, py, rx, ry = _case(name, b, r, radius, b + r + k)
    valid = np.random.default_rng(k).random(r) < 0.9
    if name == "uniform" and radius == 0.0:
        px[:10], py[:10] = rx[:10], ry[:10]    # d2 == 0 hits
        valid[:10] = True
    gi, gd, gc, scanned = grid_model(px, py, rx, ry, radius, k, valid)
    wi, wd, wc = sj_ref.radius_join(*(torch.from_numpy(a) for a in
                                      (px, py, rx, ry)), radius, k,
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(gc, wc.numpy())
    np.testing.assert_array_equal(gi, wi.numpy())
    np.testing.assert_array_equal(gd.view(np.int32), wd.numpy().view(np.int32))
    if name == "huge" or radius == 400.0:
        # the scan-every-bucket mode: boxes past GROUP cells, or cells whose
        # buckets hold the whole table
        assert scanned > 0
    elif name != "nonfinite":
        assert scanned == 0
    if name != "nonfinite":
        assert wc.sum() > 0


@pytest.mark.parametrize("name,b,r,radius", [
    ("uniform", 150, 4000, 1.5), ("boundary", 300, 300, 1.5),
    ("boundary", 300, 300, 3.0), ("clustered", 150, 3000, 1.5),
    ("nonfinite", 50, 400, 2.0)])
def test_every_counted_pair_lies_in_one_visited_cell(name, b, r, radius):
    """Every pair the dense version counts has its reference's own cell
    inside the probe's box, exactly once, and no pair with a non-finite
    coordinate is counted."""
    px, py, rx, ry = _case(name, b, r, radius, r)
    plan = sj_kernel.grid_plan(r, radius)
    cx, cy = cell_of(rx, plan.inv_cell), cell_of(ry, plan.inv_cell)
    pairs = 0
    for q in range(b):
        d = dist2(px[q], py[q], rx, ry)
        hit = np.flatnonzero(d <= F(plan.r2))
        if hit.size == 0:
            continue
        assert np.isfinite([px[q], py[q]]).all()
        assert np.isfinite(rx[hit]).all() and np.isfinite(ry[hit]).all()
        cells = visited_cells(px[q], py[q], plan)
        assert cells is not None
        for j in hit:
            same = (cells[0] == cx[j]) & (cells[1] == cy[j])
            assert same.sum() == 1, (q, j)
        pairs += hit.size
    assert pairs > 0


def test_boundary_case_has_pairs_on_the_radius():
    """The boundary case really puts pairs at d2 == r2 and one ulp out."""
    px, py, rx, ry = _boundary(np.random.default_rng(0), 200, 300, 1.5)
    r2 = F(sj_kernel.grid_plan(300, 1.5).r2)
    d = np.stack([dist2(px[q], py[q], rx, ry) for q in range(200)])
    assert (d == r2).any()
    assert ((d > r2) & (d <= np.nextafter(r2, F(np.inf)) * F(1.000001))
            ).any()


# ---------------------------------------------------------------------------
# the spatial plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [1e-30, 1e-6, 0.04, 0.75, 1.5, 3.0,
                                    400.0, 1e15])
def test_widened_radius_bounds_every_counted_offset(radius):
    """radius_w >= sqrt(r2) (1 + 2^-23): above the largest exact offset a
    pair with d2 <= r2 can have, and a float32."""
    plan = sj_kernel.grid_plan(1, radius)
    w = plan.radius_w
    assert float(F(w)) == w
    assert w >= np.sqrt(plan.r2) * (1 + 2.0**-23)
    assert w <= np.sqrt(plan.r2) * (1 + 2.0**-19) + 1e-45
    assert plan.inv_cell > 0


@pytest.mark.parametrize("r,radius,buckets", [
    (50_176, 1.5, 16_384),        # Q4, the feed
    (10_240, 3.0, 4096),          # Q5/Q7
    (100, 3.0, 4096),             # a small table
    (0, 1.5, 4096),
    (1 << 23, 1.5, 1 << 21),
    (1 << 25, 1.5, 1 << 22),      # past MAX_BUCKETS
])
def test_grid_plan_at_main_path_shapes(r, radius, buckets):
    plan = sj_kernel.grid_plan(r, radius)
    assert plan.buckets == buckets
    assert plan.buckets & (plan.buckets - 1) == 0
    pts, rank, total = sj_kernel.scratch_layout(r, plan.buckets)
    assert pts % 16 == 0 and pts >= 4 * (plan.buckets + 2)
    assert rank == pts + 16 * r and total == rank + 4 * r
    assert plan.scratch_bytes == total


def test_grid_plan_cells_fit_the_group():
    """With cells of side radius_w a finite box spans at most 4 cells an
    axis at ordinary coordinates: the 16 lanes of a group hold them."""
    rng = np.random.default_rng(1)
    for radius in (0.75, 1.5, 3.0, 400.0):
        plan = sj_kernel.grid_plan(1, radius)
        for x, y in zip(rng.uniform(-180, 180, 500),
                        rng.uniform(-180, 180, 500)):
            cells = visited_cells(F(x), F(y), plan)
            assert cells is not None and 1 <= cells[0].size <= 16


def test_spatial_constants_match_the_source():
    assert int(_define(SJ_SRC, "MIN_BUCKETS")) == sj_kernel.MIN_BUCKETS
    assert _define(SJ_SRC, "MAX_CELLS") == "GROUP"
    # the last block scans whole tiles of a 16-byte load a thread
    assert sj_kernel.MIN_BUCKETS % (4 * int(_define(SJ_SRC,
                                                   "SCAN_THREADS"))) == 0
    # the model's hash and cell clamp are the kernel's; no memset
    for c in ("0x9E3779B1u", "0x7FEB352Du", "0x85EBCA6Bu", "0xC2B2AE35u",
              "h ^= h >> 13;"):
        assert c in SJ_SRC, c
    assert "fmaxf(f, -2147483648.0f), 2147483520.0f" in SJ_SRC
    assert "cudaMemset" not in SJ_SRC
    assert SJ_SRC.count("<<<") == 4   # 3 build launches, 1 probe launch


# ---------------------------------------------------------------------------
# a numpy model of csrc/hash_probe.cu
# ---------------------------------------------------------------------------

def probe_model(probe, keys):
    """The kernel's search: LANES keys spread over the range a round, a
    ballot of those below the probe, the key at the answer carried.
    Returns (idx, found, the most rounds one probe took)."""
    r, lanes = keys.shape[0], PROBE_LANES
    idx = np.full(probe.shape, -1, np.int32)
    found = np.zeros(probe.shape, bool)
    most = 0
    for i, p in enumerate(probe):
        lo, hi, kz, rounds = 0, r, None, 0
        while lo < hi:
            n = hi - lo
            rounds += 1
            if n <= lanes:
                pos = lo + np.arange(n)
            else:
                pos = lo + (np.arange(1, lanes + 1) * n) // (lanes + 1)
            below = keys[pos] < p
            c = int(below.sum())
            assert below[:c].all()          # a prefix of the lanes
            if c < pos.size:
                hi, kz = int(pos[c]), keys[pos[c]]
            if c > 0:
                lo = int(pos[c - 1]) + 1
        most = max(most, rounds)
        if hi < r and p != KEY_SENTINEL and kz == p:
            idx[i], found[i] = hi, True
    return idx, found, most


def _probe_case(b, r, r_valid, seed):
    rng = np.random.default_rng(seed)
    keys = np.full(r, KEY_SENTINEL, np.int64)
    keys[:r_valid] = np.sort(rng.choice(4 * r_valid, r_valid,
                                        replace=False))
    if r_valid > 20:
        keys[10:14] = keys[10]                  # duplicate keys
    probe = rng.integers(-5, 4 * r_valid + 5, b).astype(np.int64)
    probe[:3] = [KEY_SENTINEL, keys[0], keys[r_valid - 1]]
    if r_valid > 20:
        probe[3] = keys[10]
    return probe, keys


@pytest.mark.parametrize("b,r,r_valid", [
    (700, 50_176, 50_000),      # the feed's shape, fewer probes
    (512, 512, 500),            # Q6's income join
    (300, 1_000_192, 1_000_000),  # Q5's suspicious_names
    (50, 17, 17), (50, 16, 16), (40, 5, 5), (10, 1, 1), (60, 300, 200)])
def test_probe_model_equals_plain_version(b, r, r_valid):
    """The kernel's search gives the plain version's idx and found
    (leftmost of duplicate keys, sentinels never found) within the plan's
    rounds of dependent reads."""
    probe, keys = _probe_case(b, r, r_valid, r)
    gi, gf, most = probe_model(probe, keys)
    wi, wf = hp_ref.sorted_probe(torch.from_numpy(probe),
                                 torch.from_numpy(keys))
    np.testing.assert_array_equal(gi, wi.numpy())
    np.testing.assert_array_equal(gf, wf.numpy())
    ri, rf = r_hp_ref.sorted_probe(probe, keys)
    np.testing.assert_array_equal(gi, np.asarray(ri))
    assert most <= search_rounds(r) <= 8
    assert gf.any() and not gf[0]


def test_probe_model_on_an_empty_column():
    gi, gf, most = probe_model(np.array([1, 2, KEY_SENTINEL]),
                               np.zeros(0, np.int64))
    assert (gi == -1).all() and not gf.any() and most == 0


def search_rounds(r):
    """The most rounds a probe's search takes over r keys: a range of
    n > PROBE_LANES keys shrinks to at most n // (PROBE_LANES + 1), the
    widest gap evenly spread pivots leave; one of at most PROBE_LANES
    keys is read whole."""
    n, rounds = r, 0
    while n > 0:
        rounds += 1
        n = 0 if n <= PROBE_LANES else n // (PROBE_LANES + 1)
    return rounds


@pytest.mark.parametrize("r,rounds", [
    (50_176, 4),          # feed / read path
    (512, 3),             # Q6's income join
    (1_000_192, 5),       # Q5's suspicious_names
    (0, 0), (16, 1), (17, 2), (2**31 - 1, 8),
])
def test_probe_rounds_at_main_path_shapes(r, rounds):
    """The dependent reads of the column a probe makes, against ~16 for a
    binary search at the feed's shape."""
    assert search_rounds(r) == rounds


def test_probe_constants_match_the_source():
    assert "(PROBE_LANES + 1)" in HP_SRC   # the model's pivots
    assert 32 % PROBE_LANES == 0 and PROBE_LANES < 32


# ---------------------------------------------------------------------------
# the envelope: refused before the device is looked at
# ---------------------------------------------------------------------------

def _f(n, dtype=torch.float32):
    return torch.zeros(n, dtype=dtype)


@pytest.mark.parametrize("args,err", [
    ((_f(4), _f(4), _f(5), _f(5), 1.5, 0), ValueError),
    ((_f(4), _f(4), _f(5), _f(5), 1.5, 17), ValueError),
    ((_f(4, torch.float64), _f(4), _f(5), _f(5), 1.5, 3), TypeError),
    ((_f(4).reshape(2, 2), _f(4), _f(5), _f(5), 1.5, 3), TypeError),
    ((_f(4), _f(3), _f(5), _f(5), 1.5, 3), ValueError),
    ((_f(4), _f(4), _f(5), _f(5), float("inf"), 3), ValueError),
    ((_f(4), _f(4), _f(5), _f(5), float("nan"), 3), ValueError),
    ((_f(4), _f(4), _f(5), _f(5), 1e20, 3), ValueError),
])
def test_radius_join_wrapper_refuses_outside_its_envelope(args, err):
    with pytest.raises(err, match="radius_join"):
        sj_kernel.radius_join(*args)


def test_radius_join_wrapper_refuses_a_wrong_mask():
    with pytest.raises(ValueError, match="ref_valid"):
        sj_kernel.radius_join(_f(4), _f(4), _f(5), _f(5), 1.5, 3,
                              torch.ones(4, dtype=torch.bool))


def test_wrappers_refuse_host_tensors_inside_the_envelope():
    with pytest.raises(ValueError, match="CUDA"):
        sj_kernel.radius_join(_f(4), _f(4), _f(5), _f(5), 1.5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        hp_kernel.sorted_probe(_f(4, torch.int64), _f(5, torch.int64))


@pytest.mark.parametrize("probe,keys,err", [
    (_f(4, torch.int32), _f(5, torch.int64), TypeError),
    (_f(4, torch.int64), _f(5, torch.float64), TypeError),
    (_f(4, torch.int64).reshape(2, 2), _f(5, torch.int64), ValueError),
])
def test_sorted_probe_wrapper_refuses_outside_its_envelope(probe, keys, err):
    with pytest.raises(err, match="sorted_probe"):
        hp_kernel.sorted_probe(probe, keys)


def test_plain_spatial_version_agrees_with_repro_kernel_formula():
    """The dense plain version the grid kernel is held to computes
    ``repro``'s kernel formula (dx*dx + dy*dy): the same counts and
    indices as repro's ref on well-separated data."""
    rng = np.random.default_rng(5)
    px, py, rx, ry = _uniform(rng, 60, 400, (-5, -5), (5, 5))
    gi, _, gc = sj_ref.radius_join(*(torch.from_numpy(a) for a in
                                     (px, py, rx, ry)), 1.0, 4)
    wi, _, wc = r_sj_ref.radius_join(px, py, rx, ry, 1.0, 4)
    d = np.stack([dist2(px[q], py[q], rx, ry) for q in range(60)])
    assert np.abs(d - 1.0).min() > 1e-4       # no pair on the boundary
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("ops,most,ok", [
    ({"kernel": 4}, 4, True),
    ({"kernel": 1}, 1, True),
    ({"kernel": 5}, 4, False),
    ({"kernel": 3, "memset": 1}, 4, False),
    ({"kernel": 2, "memcpy": 1}, 4, False),
    ({}, 4, False),
])
def test_launch_check_holds_graph_ops(ops, most, ok):
    """chip_smoke's launch check over a captured graph's nodes: 1 to
    ``most`` kernels and nothing else, and none is a failure."""
    if ok:
        chip_smoke.check_ops("join", ops, most)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_ops("join", ops, most)


def test_spatial_launch_check_reads_every_case():
    rows = {"q4": {"graph_ops": {"kernel": 4}},
            "whole_table": {"graph_ops": {"kernel": 4, "memset": 1}}}
    with pytest.raises(AssertionError, match="whole_table"):
        chip_smoke.check_spatial_launches(rows)
    chip_smoke.check_spatial_launches({"q4": rows["q4"]})
