"""The host side of the flash kernel's wgmma body, on the CPU: which body
each (dtype, D) takes, and the TMA tensor-map geometry kernel.py computes
and hands to the C side (dims, byte strides, boxes) at the serving shape
and at every bf16 case chip_smoke.py holds on the card; the shared launch
path's one-time binding.  The kernel itself runs only on a card
(tests/test_torch_cuda.py); the plain version at the wgmma body's edge
shapes is held to ``repro``'s oracle in tests/test_torch_flash.py."""

import ctypes
import ctypes.util
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import CudaKernel
from repro_torch.kernels.flash_attention import kernel

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke_cases():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_CASES


FLASH_CASES = _chip_smoke_cases()
# (dtype, D) -> body, for every case of chip_smoke.FLASH_CASES
BODIES = {("bfloat16", 128): "wgmma", ("bfloat16", 64): "wgmma",
          ("bfloat16", 112): "mma_sync", ("bfloat16", 72): "cuda_core",
          ("float32", 64): "cuda_core", ("float32", 112): "cuda_core",
          ("float32", 128): "cuda_core"}


def _case_id(c):
    b, s, t, h, kv, d, causal, dt = c
    return f"B{b}-S{s}-T{t}-H{h}-Kv{kv}-D{d}-{'causal' if causal else 'full'}-{dt}"


@pytest.mark.parametrize("case", FLASH_CASES, ids=_case_id)
def test_body_of_each_chip_smoke_case(case):
    d, dt = case[5], case[7]
    assert kernel.body(getattr(torch, dt), d) == BODIES[(dt, d)]


def _meta(*shape):
    return torch.empty(*shape, dtype=torch.bfloat16, device="meta")


def test_serving_shape_geometry():
    """deepseek-coder-33b's prefill: q (1, 1536, 56, 128), k and v
    (1, 1536, 8, 128), contiguous."""
    q, k = _meta(1, 1536, 56, 128), _meta(1, 1536, 8, 128)
    gq = kernel.tma_geometry(q.shape, q.stride(), kernel.WGMMA_Q_ROWS)
    gk = kernel.tma_geometry(k.shape, k.stride(), kernel.WGMMA_KV_ROWS)
    assert gq.dims == (128, 56, 1536, 1)
    assert gq.strides == (256, 56 * 256, 1536 * 56 * 256)
    assert gq.box == (64, 1, 128, 1)
    assert gk.dims == (128, 8, 1536, 1)
    assert gk.strides == (256, 8 * 256, 1536 * 8 * 256)
    assert gk.box == (64, 1, 64, 1)
    assert gq.d_boxes == gk.d_boxes == 2
    assert gq.problems() == [] and gk.problems() == []
    assert gq.flat() == (128, 56, 1536, 1, 256, 14336, 22020096,
                         64, 1, 128, 1)


@pytest.mark.parametrize(
    "case", [c for c in FLASH_CASES
             if kernel.body(getattr(torch, c[7]), c[5]) == "wgmma"],
    ids=_case_id)
def test_geometry_of_each_wgmma_case(case):
    b, s, t, h, kv, d, _, _ = case
    for x, rows in ((_meta(b, s, h, d), kernel.WGMMA_Q_ROWS),
                    (_meta(b, t, kv, d), kernel.WGMMA_KV_ROWS)):
        g = kernel.tma_geometry(x.shape, x.stride(), rows)
        assert g.dims == (d, x.shape[2], x.shape[1], b)
        assert all(st % 16 == 0 and st > 0 for st in g.strides)
        assert all(1 <= n <= 256 for n in g.box)
        assert g.box[0] * 2 == 128           # the swizzle's span
        assert g.box[2] == rows
        assert g.d_boxes == d // 64 == (2 if d == 128 else 1)
        assert g.problems() == []


def test_geometry_of_views():
    """A view whose D is unit-stride and whose other strides are multiples
    of 16 bytes maps in place; others are refused (and copied by the
    wrapper)."""
    k = _meta(2, 8, 300, 64).transpose(1, 2)          # (B, T, Kv, D) view
    g = kernel.tma_geometry(k.shape, k.stride(), kernel.WGMMA_KV_ROWS)
    assert g.dims == (64, 8, 300, 2)
    assert g.strides == (300 * 64 * 2, 64 * 2, 8 * 300 * 64 * 2)
    assert g.problems() == []
    q = _meta(1, 10, 4, 68)[..., :64]                 # rows of 136 bytes
    g = kernel.tma_geometry(q.shape, q.stride(), kernel.WGMMA_Q_ROWS)
    assert g.problems() and "multiples of 16" in g.problems()[0]
    with pytest.raises(ValueError, match="unit-stride"):
        x = _meta(1, 10, 4, 128)[..., ::2]
        kernel.tma_geometry(x.shape, x.stride(), kernel.WGMMA_Q_ROWS)
    bad = kernel.TensorMapGeometry((128, 4, 10, 1), (256, 1024, 10240),
                                   (128, 1, 300, 1))
    assert len(bad.problems()) == 2        # box past 256, inner past 128 B


def test_launch_path_binds_entry_points_once(monkeypatch, tmp_path):
    """CudaKernel loads its library and binds each entry point once; later
    lookups take neither the build lock nor getattr (libc stands in for a
    built kernel)."""
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no libc to stand in for a kernel library")
    k = CudaKernel("stand_in", tmp_path / "none.cu", {"abs": (ctypes.c_int,)})
    built = []
    monkeypatch.setattr(k, "compile", lambda: built.append(1) or libc)
    lib = k.lib()
    assert k.lib() is lib and built == [1]
    assert k._fns["abs"](-7) == 7
    assert k._fns["abs"].argtypes == [ctypes.c_int]
