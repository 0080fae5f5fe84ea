"""The read path's two aggregation kernels as redesigned for Hopper, on the
CPU: the launch plans their wrappers compute in Python (shared memory,
rows per block, scratch, launches), the plans' constants against the CUDA
sources, the wrappers' refusals outside their envelope (checked before the
device, so they raise here), and the count mode's plain path held to
``repro``'s reference count.  tests/test_torch_cuda.py holds the kernels
themselves to their plain versions on the card."""

import re

import numpy as np
import pytest
import torch

from repro.core.enrich import dispatch as r_dispatch
from repro.kernels import dispatch_mode
from repro_torch.core.enrich import dispatch as t_dispatch
from repro_torch.kernels import path_tape_start, path_tape_stop
from repro_torch.kernels.segment_reduce import kernel as sr_kernel
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.kernels.segment_reduce import ref as sr_ref
from repro_torch.kernels.segment_topk import kernel as st_kernel
from repro_torch.kernels.segment_topk import ops as st_ops
from repro_torch.kernels.segment_topk import ref as st_ref

SMEM = 232_448          # shared memory a Hopper block can use
STATIC_SMEM = 48 * 1024  # above this a kernel needs the opt-in attribute

ROWS = [1, 5, 100, 2048, 4096, 8191, 8192, 8193, 20_000, 32_768,
        1_000_192, 1 << 20, 1_081_344, 1_081_345, 1 << 22, 2**31 - 1]
SEGMENTS = [1, 2, 6, 7, 128, 129, 256, 1000, 2047, 2048]


def _define(source, name):
    m = re.search(rf"#define {name} (\S+)", source)
    assert m, name
    return m.group(1)


# ---------------------------------------------------------------------------
# segment_topk: the launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", ROWS)
def test_topk_geometry_fits_hopper(r):
    """For every S <= 2048 and k <= 16: stage 1's shared memory fits a
    block, stage 2's needs no opt-in, the shares cover the rows with no
    empty block, the scratch holds [S][blocks][k] keys and [S][blocks]
    counts, and a call launches once exactly when one block takes it."""
    for s in SEGMENTS:
        for k in (1, 2, 3, 16):
            g = st_kernel.geometry(r, s, k)
            assert g.smem_bytes <= SMEM
            assert g.merge_smem_bytes <= STATIC_SMEM
            assert 1 <= g.blocks <= min(st_kernel.SM_COUNT,
                                        st_kernel.MAX_BLOCKS)
            assert g.rows_per_block % 4 == 0            # 16-byte loads
            assert g.blocks * g.rows_per_block >= r
            assert (g.blocks - 1) * g.rows_per_block < r
            assert g.passes == -(-g.rows_per_block // st_kernel.PASS_ROWS)
            one = r <= st_kernel.PASS_ROWS
            assert (g.blocks == 1) == one
            assert g.launches == (1 if one else 2)
            if one:
                assert g.scratch_bytes == g.merge_smem_bytes == 0
            else:
                assert g.scratch_bytes == s * g.blocks * (8 * k + 1)


@pytest.mark.parametrize("r,s,k,blocks,rows,passes,launches", [
    (2048, 128, 3, 1, 2048, 1, 1),              # an eager unit
    (2048, 256, 16, 1, 2048, 1, 1),             # a unit of phase 7(c)
    (32_768, 256, 16, 16, 2048, 1, 2),          # a merged unit
    (1 << 20, 256, 16, 132, 7944, 1, 2),        # a batched scan
    (1 << 22, 256, 16, 132, 31_776, 4, 2),      # past one pass a block
])
def test_topk_geometry_at_read_path_shapes(r, s, k, blocks, rows, passes,
                                           launches):
    g = st_kernel.geometry(r, s, k)
    assert (g.blocks, g.rows_per_block, g.passes, g.launches) == (
        blocks, rows, passes, launches)


def test_topk_geometry_follows_the_sm_count():
    """A card with fewer SMs gets fewer, longer shares."""
    g = st_kernel.geometry(1 << 20, 256, 16, sms=66)
    assert g.blocks == 66 and g.rows_per_block == 15_888 and g.passes == 2


def test_topk_constants_match_the_source():
    src = st_kernel.KERNEL.source.read_text()
    assert int(_define(src, "TOPK_THREADS")) == st_kernel.THREADS
    assert int(_define(src, "TOPK_MAX_SEGMENTS")) == st_kernel.MAX_SEGMENTS
    assert int(_define(src, "TOPK_MAX_K")) == st_kernel.MAX_K
    assert int(_define(src, "ROWS_PER_THREAD")) * st_kernel.THREADS == \
        st_kernel.PASS_ROWS
    assert int(_define(src, "MERGE_THREADS")) * int(
        _define(src, "MERGE_LISTS")) == st_kernel.MAX_BLOCKS
    # the launcher issues no memset and sizes shared memory as geometry()
    assert "cudaMemset" not in src
    assert "PASS_ROWS * (8 + 2) + (2 * s + 32) * 4" in src
    assert "(size_t)blocks * (k + 1) * 8" in src


# ---------------------------------------------------------------------------
# segment_sum: the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("r", ROWS)
def test_sum_plan_fits_hopper(dtype, r):
    """Direct mode (one block, no memset) for up to DIRECT_ROWS rows and
    segments, shared-memory sums where the table fits and a block reads 4
    rows per segment, global atomics otherwise; shared memory always
    fits."""
    isz = dtype.itemsize
    for s in SEGMENTS + [16_385, 50_000, 100_000]:
        p = sr_kernel.plan(r, s, isz)
        assert p.smem_bytes <= SMEM
        assert p.memset == (p.mode != "direct")
        assert p.mode in sr_kernel.MODES
        if p.mode == "direct":
            assert r <= sr_kernel.DIRECT_ROWS and p.blocks == 1
            assert s <= sr_kernel.DIRECT_ROWS
            assert p.smem_bytes == s * isz
        elif p.mode == "shared":
            assert 1 < p.blocks <= sr_kernel.SM_COUNT
            assert 4 * s <= r // p.blocks and p.smem_bytes == s * isz
        else:
            assert p.smem_bytes == 0
            assert 1 <= p.blocks <= 4 * sr_kernel.SM_COUNT
        if s * isz > SMEM:
            assert p.mode == "global"


@pytest.mark.parametrize("r,s,itemsize,mode", [
    (2048, 128, 4, "direct"),             # an eager unit's count
    (1 << 20, 256, 8, "shared"),          # the batched path's sum / mean
    (1_000_192, 16_385, 4, "global"),     # the feed's Q6 count
    (5000, 100_000, 8, "global"),         # a table past shared memory
    (2560, 16_385, 4, "global"),          # few rows into many segments
])
def test_sum_plan_at_main_path_shapes(r, s, itemsize, mode):
    assert sr_kernel.plan(r, s, itemsize).mode == mode


def test_sum_constants_match_the_source():
    src = sr_kernel.KERNEL.source.read_text()
    assert int(_define(src, "SUM_THREADS")) == sr_kernel.THREADS
    assert int(_define(src, "SUM_MAX_SMEM")) == sr_kernel.SMEM_BYTES
    for name, code in sr_kernel.MODES.items():
        assert re.search(rf"MODE_{name.upper()} = {code}\b", src), name
    for dtype, code in sr_kernel.DTYPES.items():
        assert f"{code} {str(dtype).split('.')[-1]}" in src, dtype


# ---------------------------------------------------------------------------
# the envelope: refused before the device is looked at
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("values,seg,s,k,err", [
    (torch.zeros(4), torch.zeros(4, dtype=torch.int32), 2, 3, TypeError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(5, dtype=torch.int32),
     2, 3, ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
     0, 3, ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
     2049, 3, ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
     2, 0, ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
     2, 17, ValueError),
])
def test_topk_wrapper_refuses_outside_its_envelope(values, seg, s, k, err):
    with pytest.raises(err, match="segment_topk"):
        st_kernel.segment_topk_idx(values, seg, s, k)


@pytest.mark.parametrize("call,err", [
    (lambda: sr_kernel.segment_sum(torch.zeros(4, dtype=torch.int16),
                                   torch.zeros(4, dtype=torch.int32), 2),
     TypeError),
    (lambda: sr_kernel.segment_sum(torch.zeros(4), torch.zeros(4), 2),
     TypeError),
    (lambda: sr_kernel.segment_sum(torch.zeros(4),
                                   torch.zeros(3, dtype=torch.int32), 2),
     ValueError),
    (lambda: sr_kernel.segment_sum(torch.zeros(4),
                                   torch.zeros(4, dtype=torch.int32), -1),
     ValueError),
    (lambda: sr_kernel.segment_count(torch.zeros(4), 2), TypeError),
    (lambda: sr_kernel.segment_count(torch.zeros((2, 2), dtype=torch.int32),
                                     2), ValueError),
    (lambda: sr_kernel.segment_count(torch.zeros(4, dtype=torch.int32),
                                     2**31), ValueError),
])
def test_sum_wrapper_refuses_outside_its_envelope(call, err):
    with pytest.raises(err):
        call()


# ---------------------------------------------------------------------------
# the count mode's plain path against repro's reference count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seg_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("r,s,masked", [(2048, 128, False), (700, 7, True),
                                        (5000, 16_385, True), (1, 1, False),
                                        (0, 3, False)])
def test_segment_count_on_cpu_matches_reference(seg_dtype, r, s, masked):
    """``dispatch.segment_count`` on the CPU (the plain path the card's
    count mode replaces) equals ``repro``'s count: rows outside [0, S)
    and rows masked invalid dropped, int32 out."""
    rng = np.random.default_rng(r + s)
    seg = rng.integers(-2, s + 2, r).astype(seg_dtype)
    valid = rng.random(r) < 0.8 if masked else None
    path_tape_start()
    got = t_dispatch.segment_count(
        torch.from_numpy(seg), s,
        None if valid is None else torch.from_numpy(valid))
    assert path_tape_stop() == {("segment_sum", "reference"): 1}
    with dispatch_mode("reference"):
        want = np.asarray(r_dispatch.segment_count(
            seg, s, None if valid is None else valid))
    assert got.dtype == torch.int32 and got.shape == (s,)
    np.testing.assert_array_equal(got.numpy(), want)
    keep = (seg >= 0) & (seg < s) & (True if valid is None else valid)
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(seg[keep], minlength=s))


def test_count_ops_route_the_cpu_to_the_plain_count():
    seg = torch.tensor([0, 2, 2, 5, -1, 1], dtype=torch.int64)
    got = sr_ops.segment_count(seg, 4)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.tensor([1, 1, 2, 0], dtype=torch.int32))
    assert torch.equal(sr_ref.segment_count(seg, 4), got)
    m = torch.empty(9, dtype=torch.int64, device="meta")
    out = sr_ops.segment_count(m, 3)
    assert out.device.type == "meta" and out.shape == (3,)


# ---------------------------------------------------------------------------
# the wrapper leaves its caller's tensor alone
# ---------------------------------------------------------------------------

def _emulated_launch(captured):
    """A stand-in for ``KERNEL.launch`` on host memory: it reads the int32
    values and segments the wrapper hands the kernel (by their pointers)
    and writes the plain version's rows into the output, as the card
    would."""
    import ctypes

    def launch(symbol, dev, vptr, sptr, r, s, k, blocks, rows, scratch,
               optr):
        vals = np.ctypeslib.as_array((ctypes.c_int32 * r).from_address(vptr))
        segs = np.ctypeslib.as_array((ctypes.c_int32 * r).from_address(sptr))
        captured.append(vals.copy())
        want = st_ref.segment_topk_idx(torch.from_numpy(vals.copy()),
                                       torch.from_numpy(segs.copy()), s, k)
        ctypes.memmove(optr, want.numpy().ctypes.data, s * k * 4)
    return launch


@pytest.fixture
def host_kernel(monkeypatch):
    """segment_topk's kernel path run on host tensors: the device checks
    and the SM count are stubbed and the launch is emulated."""
    captured = []
    monkeypatch.setattr(st_kernel, "check_same_cuda",
                        lambda *ts: ts[0].device)
    monkeypatch.setattr(st_kernel, "sm_count", lambda dev: st_kernel.SM_COUNT)
    monkeypatch.setattr(st_kernel.KERNEL, "launch", _emulated_launch(captured))
    return captured


def _wide_values(r, seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(-(2**40), 2**40, r).astype(np.int64)
    v[:4] = [-1, 2**31, 2**31 - 1, 2**62]
    return v


@pytest.mark.parametrize("r", [600, 9000])
def test_topk_wrapper_leaves_int64_values_unchanged(host_kernel, r):
    """Values below 0 and past 2^31 - 1 rank clipped, but the clip is
    made on a copy: the caller's int64 tensor is the same after the call,
    and the kernel is handed the clipped int32 copy."""
    v = _wide_values(r, r)
    seg = np.arange(r, dtype=np.int32) % 7
    vt = torch.from_numpy(v.copy())
    got = st_kernel.segment_topk_idx(vt, torch.from_numpy(seg), 7, 3)
    np.testing.assert_array_equal(vt.numpy(), v)
    np.testing.assert_array_equal(host_kernel[0], np.clip(v, 0, 2**31 - 1))
    assert torch.equal(got, st_ref.segment_topk_idx(torch.from_numpy(v),
                                                    torch.from_numpy(seg),
                                                    7, 3))


def test_dispatch_topk_kernel_path_returns_unclipped_values(host_kernel,
                                                            monkeypatch):
    """``dispatch.segment_topk`` on the kernel path gathers its values from
    the caller's unchanged tensor: the unclipped originals, as ``repro``
    returns them, equal to the plain path's output."""
    r = 600
    v = _wide_values(r, 3)
    seg = np.arange(r, dtype=np.int32) % 7
    ids = np.arange(r, dtype=np.int64) * 10
    monkeypatch.setattr(t_dispatch, "on_cuda", lambda t: True)
    monkeypatch.setattr(st_ops, "on_cuda", lambda t: True)
    vt = torch.from_numpy(v.copy())
    path_tape_start()
    pay, val = t_dispatch.segment_topk(vt, torch.from_numpy(seg),
                                       torch.from_numpy(ids), 7, 2)
    assert path_tape_stop() == {("segment_topk", "kernel"): 1}
    np.testing.assert_array_equal(vt.numpy(), v)
    monkeypatch.undo()
    wpay, wval = t_dispatch.segment_topk(torch.from_numpy(v),
                                         torch.from_numpy(seg),
                                         torch.from_numpy(ids), 7, 2)
    assert torch.equal(pay, wpay) and torch.equal(val, wval)
    with dispatch_mode("reference"):
        rpay, rval = r_dispatch.segment_topk(v, seg, ids, 7, 2)
    np.testing.assert_array_equal(val.numpy(), np.asarray(rval))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(rpay))
    assert (val.numpy() > 2**31 - 1).any() or (val.numpy() < 0).any()
