"""The port's kernel modules (repro_torch/kernels) held to the reference's:
each plain PyTorch version against ``repro``'s Pallas kernel in interpret
mode and against ``repro``'s own ``ref.py``, on the same numpy inputs.
The cases mirror tests/test_kernels.py: out-of-range segments, sentinel
probes, duplicate keys, distance ties, reference tables smaller than k.

On the CPU a kernel wrapper routes to its plain version because the
tensor lies on the CPU; tests/test_torch_cuda.py holds the hand kernels to
their plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.refdata import KEY_SENTINEL
from repro.kernels.hash_probe import ref as hp_ref
from repro.kernels.hash_probe.kernel import sorted_probe_pallas
from repro.kernels.segment_reduce import ref as sr_ref
from repro.kernels.segment_reduce.kernel import segment_sum_pallas
from repro.kernels.segment_topk import ref as st_ref
from repro.kernels.spatial_join import ref as sj_ref
from repro.kernels.spatial_join.kernel import radius_join_pallas
from repro_torch.core.refdata import KEY_SENTINEL as T_KEY_SENTINEL
from repro_torch.kernels.hash_probe import kernel as t_hp_kernel
from repro_torch.kernels.hash_probe import ops as t_hp_ops
from repro_torch.kernels.segment_reduce import kernel as t_sr_kernel
from repro_torch.kernels.segment_reduce import ops as t_sr_ops
from repro_torch.kernels.segment_topk import ops as t_st_ops
from repro_torch.kernels.spatial_join import kernel as t_sj_kernel
from repro_torch.kernels.spatial_join import ops as t_sj_ops


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_key_sentinel_matches_reference():
    assert T_KEY_SENTINEL == KEY_SENTINEL == np.iinfo(np.int64).max


# ---------------------------------------------------------------------------
# segment_reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("r,s", [(100, 7), (2048, 128), (1000, 300),
                                 (1, 1), (2000, 129)])
def test_segment_sum_matches_pallas_and_ref(dtype, r, s):
    rng = np.random.default_rng(r + s)
    vals = rng.integers(0, 100, r).astype(dtype)
    seg = rng.integers(0, s, r).astype(np.int32)
    got = t_sr_ops.segment_sum(t(vals), t(seg), s)
    pallas = segment_sum_pallas(jnp.asarray(vals), jnp.asarray(seg), s,
                                block_r=512, interpret=True)
    want = sr_ref.segment_sum(jnp.asarray(vals), jnp.asarray(seg), s)
    assert got.dtype == torch.from_numpy(vals).dtype and got.shape == (s,)
    # small integers: every summation order gives the same value
    np.testing.assert_array_equal(n(got), np.asarray(pallas))
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_segment_sum_64bit_matches_ref(dtype):
    """The port's kernel takes 64-bit inputs directly (the reference sends
    them to XLA); the plain version matches the reference's oracle."""
    rng = np.random.default_rng(5)
    vals = (rng.integers(-2**40, 2**40, 3000).astype(dtype)
            if dtype == np.int64 else rng.normal(size=3000))
    seg = rng.integers(0, 50, 3000).astype(np.int32)
    got = n(t_sr_ops.segment_sum(t(vals), t(seg), 50))
    want = np.asarray(sr_ref.segment_sum(jnp.asarray(vals),
                                         jnp.asarray(seg), 50))
    assert got.dtype == want.dtype
    if dtype == np.int64:
        np.testing.assert_array_equal(got, want)
    else:
        # summation order differs: 1e-12 of the segment's absolute sum
        scale = np.bincount(seg, np.abs(vals), 50)
        assert np.all(np.abs(got - want) <= 1e-12 * scale + 1e-300)


def test_segment_sum_drops_out_of_range():
    vals = np.array([1, 2, 3, 4], np.int32)
    seg = np.array([0, 5, 0, -1], np.int32)   # 5 >= S and -1 < 0: dropped
    got = t_sr_ops.segment_sum(t(vals), t(seg), 2)
    np.testing.assert_array_equal(n(got), [4, 0])
    pallas = segment_sum_pallas(jnp.asarray(vals[:3]), jnp.asarray(seg[:3]),
                                2, block_r=512, interpret=True)
    np.testing.assert_array_equal(n(got), np.asarray(pallas))


# ---------------------------------------------------------------------------
# hash_probe
# ---------------------------------------------------------------------------

def _probe_case(b, r, cap, seed):
    rng = np.random.default_rng(seed)
    ref_real = rng.choice(10 * r, r, replace=False).astype(np.int64)
    keys = np.full((cap,), KEY_SENTINEL, np.int64)
    keys[:r] = np.sort(ref_real)
    probe = rng.integers(0, 12 * r, b).astype(np.int64)
    probe[0] = ref_real[0]                       # at least one hit
    if b > 2:
        probe[1] = KEY_SENTINEL                  # sentinel probes miss
        probe[2] = probe[0]                      # duplicate probe
    return probe, keys


@pytest.mark.parametrize("b,r,cap", [(10, 8, 16), (500, 2000, 2048),
                                     (1, 1, 4), (300, 1000, 1100)])
def test_sorted_probe_matches_pallas_and_ref(b, r, cap):
    probe, keys = _probe_case(b, r, cap, b * r)
    gi, gf = t_hp_ops.sorted_probe(t(probe), t(keys))
    pi, pf = sorted_probe_pallas(jnp.asarray(probe), jnp.asarray(keys),
                                 block_b=128, block_r=512, interpret=True)
    wi, wf = hp_ref.sorted_probe(jnp.asarray(probe), jnp.asarray(keys))
    assert gi.dtype == torch.int32 and gf.dtype == torch.bool
    for i, f in ((pi, pf), (wi, wf)):
        np.testing.assert_array_equal(n(gf), np.asarray(f))
        np.testing.assert_array_equal(n(gi), np.asarray(i))


def test_sorted_probe_64bit_keys_and_duplicates():
    """Keys above 2^32, a sentinel probe, and duplicate reference keys
    (leftmost match wins)."""
    keys = np.array([5, 7, 7, 2**40 + 7, 2**55 + 1, KEY_SENTINEL],
                    np.int64)
    probe = np.array([2**55 + 1, 2**40 + 7, 2**40 + 8, 5, KEY_SENTINEL, 7],
                     np.int64)
    gi, gf = t_hp_ops.sorted_probe(t(probe), t(keys))
    np.testing.assert_array_equal(n(gf), [True, True, False, True, False,
                                          True])
    np.testing.assert_array_equal(n(gi), [4, 3, -1, 0, -1, 1])
    wi, wf = hp_ref.sorted_probe(jnp.asarray(probe), jnp.asarray(keys))
    np.testing.assert_array_equal(n(gi), np.asarray(wi))
    np.testing.assert_array_equal(n(gf), np.asarray(wf))


# ---------------------------------------------------------------------------
# spatial_join
# ---------------------------------------------------------------------------

def _spatial_case(b, r, seed, span=10.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.uniform(-span, span, b).astype(f),
            rng.uniform(-span, span, b).astype(f),
            rng.uniform(-span, span, r).astype(f),
            rng.uniform(-span, span, r).astype(f),
            rng.random(r) < 0.9)


@pytest.mark.parametrize("b,r,k", [(40, 60, 3), (300, 2000, 8), (1, 1, 2),
                                   (257, 1025, 1)])
def test_radius_join_matches_pallas_and_ref(b, r, k):
    px, py, rx, ry, valid = _spatial_case(b, r, b + r + k)
    gi, gd, gc = t_sj_ops.radius_join(t(px), t(py), t(rx), t(ry), 4.0, k,
                                      t(valid))
    pi, pd, pc = radius_join_pallas(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(rx), jnp.asarray(ry),
        4.0, k, jnp.asarray(valid), block_b=128, block_r=256,
        interpret=True)
    wi, wd, wc = sj_ref.radius_join(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(rx), jnp.asarray(ry),
        4.0, k, jnp.asarray(valid))
    assert gi.shape == (b, k) and gi.dtype == torch.int32
    assert gd.dtype == torch.float32 and gc.dtype == torch.int32
    for i, d, c in ((pi, pd, pc), (wi, wd, wc)):
        np.testing.assert_array_equal(n(gc), np.asarray(c))
        np.testing.assert_array_equal(n(gi), np.asarray(i))
        # the same dx*dx + dy*dy formula; 1e-5 covers a contracted FMA
        np.testing.assert_allclose(n(gd), np.asarray(d), rtol=1e-5,
                                   atol=1e-5)


def test_radius_join_ties_go_to_lower_index():
    """Equidistant reference points rank by index — the kernel's order and
    the reference kernel's; the plain version uses a stable sort."""
    f = np.float32
    px, py = np.array([0.0], f), np.array([0.0], f)
    rx = np.array([1.0, -1.0, 0.0, 0.0, 2.0, 0.5], f)
    ry = np.array([0.0, 0.0, 1.0, -1.0, 0.0, 0.0], f)
    valid = np.array([True, True, True, True, True, False])
    gi, gd, gc = t_sj_ops.radius_join(t(px), t(py), t(rx), t(ry), 1.0, 3,
                                      t(valid))
    np.testing.assert_array_equal(n(gi), [[0, 1, 2]])
    np.testing.assert_array_equal(n(gc), [4])
    pi, _, pc = radius_join_pallas(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(rx), jnp.asarray(ry),
        1.0, 3, jnp.asarray(valid), block_b=8, block_r=8, interpret=True)
    np.testing.assert_array_equal(n(gi), np.asarray(pi))
    np.testing.assert_array_equal(n(gc), np.asarray(pc))


def test_radius_join_tiny_reference_pads_slots():
    """R < k: the missing slots are -1 / inf, as in the reference."""
    px, py, rx, ry, _ = _spatial_case(20, 2, 9, span=1.0)
    gi, gd, gc = t_sj_ops.radius_join(t(px), t(py), t(rx), t(ry), 5.0, 4)
    wi, wd, wc = sj_ref.radius_join(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(rx), jnp.asarray(ry),
        5.0, 4)
    assert np.all(n(gi)[:, 2:] == -1) and np.all(np.isinf(n(gd)[:, 2:]))
    np.testing.assert_array_equal(n(gi), np.asarray(wi))
    np.testing.assert_array_equal(n(gc), np.asarray(wc))
    np.testing.assert_allclose(n(gd), np.asarray(wd), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# segment_topk (plain version only; its kernel is the next slice)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,s,k", [(64, 200, 4), (300, 12, 3), (512, 1, 1),
                                   (1000, 40, 5)])
def test_segment_topk_plain_matches_ref(r, s, k):
    rng = np.random.default_rng(r * s + k)
    vals = rng.integers(-5, 50, r).astype(np.int32)   # ties and negatives
    seg = rng.integers(-1, s + 1, r).astype(np.int32)  # out-of-range too
    got = t_st_ops.segment_topk_idx(t(vals), t(seg), s, k)
    want = st_ref.segment_topk_idx(jnp.asarray(vals), jnp.asarray(seg), s,
                                   k)
    assert got.dtype == torch.int32 and got.shape == (s, k)
    np.testing.assert_array_equal(n(got), np.asarray(want))


# ---------------------------------------------------------------------------
# shape-only (meta) runs and the wrappers' checks
# ---------------------------------------------------------------------------

def test_plain_versions_run_on_meta_tensors():
    """Plan validation runs every stage on meta tensors: each plain
    version must give its shapes and dtypes without data."""
    m = torch.device("meta")
    i, f = t_hp_ops.sorted_probe(torch.empty(7, dtype=torch.int64,
                                             device=m),
                                 torch.empty(9, dtype=torch.int64,
                                             device=m))
    assert (i.shape, i.dtype, f.dtype) == ((7,), torch.int32, torch.bool)
    p = torch.empty(5, device=m)
    q = torch.empty(11, device=m)
    i, d, c = t_sj_ops.radius_join(p, p, q, q, 1.5, 8,
                                   torch.empty(11, dtype=torch.bool,
                                               device=m))
    assert (i.shape, d.shape, c.shape) == ((5, 8), (5, 8), (5,))
    s = t_sr_ops.segment_sum(torch.empty(13, dtype=torch.int64, device=m),
                             torch.empty(13, dtype=torch.int32, device=m),
                             4)
    assert (s.shape, s.dtype) == ((4,), torch.int64)


@pytest.mark.parametrize("mod", [t_hp_kernel, t_sj_kernel, t_sr_kernel])
def test_c_entry_points_match_ctypes_signatures(mod):
    """Each exported C function takes exactly the arguments its ctypes
    binding passes (a wrong count would only surface on the card)."""
    import ctypes
    import re
    src = mod.KERNEL.source.read_text()
    for sym, argtypes in mod.KERNEL.symbols.items():
        m = re.search(r'extern "C" int ' + sym + r"\(([^)]*)\)", src)
        assert m, sym
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), (sym, params)
        assert params[-1] == "void* stream"
        for p, a in zip(params, argtypes):
            ctype = p.rsplit(" ", 1)[0].replace("const ", "")
            assert {"void*": ctypes.c_void_p, "int": ctypes.c_int,
                    "float": ctypes.c_float,
                    "long long": ctypes.c_longlong}[ctype] is a, p


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor never reaches a kernel
    (ops.py routes it to the plain version first)."""
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        t_hp_kernel.sorted_probe(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        t_sr_kernel.segment_sum(x, x.int(), 2)
    f = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        t_sj_kernel.radius_join(f, f, f, f, 1.0, 2)
