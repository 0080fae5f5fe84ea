"""The port's dense transformer on the CPU against ``repro``'s: the same
parameters (``repro``'s, carried across by ``params_from_numpy``) and the
same numpy inputs through the layers, ``apply``, ``prefill`` and
``decode_step`` of both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import api as japi
from repro.models import layers as JL
from repro_torch.configs import ALL_ARCHS as T_ALL_ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch import kernels
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models.params import params_from_numpy, tree_leaves

ARCH = "deepseek-coder-33b"
# float32 on both sides; the two packages sum the products of each
# matmul in different orders (~1e-6 relative per layer)
TOL = 2e-5


def _pair(arch=ARCH):
    jcfg = j_smoke_config(arch)
    tcfg = t_smoke_config(arch)
    jp = japi.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _close_to_scale(got, want):
    """TOL of the largest |value|: the caches' entries reach ~10, and an
    entry that cancels to ~0.3 keeps the absolute error of its terms."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=TOL,
        atol=TOL * max(1.0, float(np.abs(want).max())))


def test_configs_are_repro_configs():
    """Every field equal, except repro's use_pallas_attention, which the
    port does not have: its attention routes by device."""
    from repro.configs import ALL_ARCHS, get_config

    def fields(cfg):
        d = dict(cfg.__dict__)
        d.pop("use_pallas_attention", None)
        return d

    assert T_ALL_ARCHS == ALL_ARCHS
    for arch in ALL_ARCHS:
        assert "use_pallas_attention" not in t_get_config(arch).__dict__
        assert t_get_config(arch).__dict__ == fields(get_config(arch))
        assert (t_smoke_config(arch).__dict__
                == fields(j_smoke_config(arch)))


def test_param_specs_and_count_match():
    jcfg, tcfg, jp, tp = _pair()
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    flat_j = jax.tree.leaves(jshapes, is_leaf=lambda x: isinstance(x, tuple))
    flat_t = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
              for x in tree_leaves(tp)]
    assert sorted(flat_j) == sorted(flat_t)
    # full width: the same count as repro, no tensor allocated
    full = t_get_config(ARCH)
    from repro.configs import get_config
    assert tapi.param_count(full) == japi.param_count(get_config(ARCH))


def test_init_params_follows_the_std_rule():
    cfg = t_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    p = tapi.init_params(cfg, gen)
    assert torch.equal(p["layers"]["ln1"], torch.ones_like(p["layers"]["ln1"]))
    # lecun: fan-in is the second-to-last dim; embed leaves std 0.02
    wq = p["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.num_heads ** -0.5) < 0.05
    assert abs(float(p["embed"]["tok"].std()) - 0.02) < 0.002
    again = tapi.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(p), tree_leaves(again)))


def test_params_from_numpy_keeps_bfloat16():
    a = jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
                    jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("s", [16, 256])   # repro: unchunked, chunked
def test_sdpa_matches_both_repro_branches(s):
    cfg = j_smoke_config(ARCH).replace(num_heads=4, num_kv_heads=2,
                                       head_dim=16)
    tcfg = t_smoke_config(ARCH).replace(num_heads=4, num_kv_heads=2,
                                        head_dim=16)
    rng = np.random.default_rng(s)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (2, s))
    want = JL._sdpa(cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    pos, pos, None, None, causal=True)
    kernels.reset_path_stats()
    got = TL._sdpa(tcfg, torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), None, None, None, None, causal=True)
    _close(got, want)
    # the kernel's case: no plain-path dispatch recorded
    assert ("flash_attention", "reference") not in kernels.path_stats()


def test_sdpa_with_segments_takes_the_plain_path():
    cfg = j_smoke_config(ARCH)
    tcfg = t_smoke_config(ARCH)
    rng = np.random.default_rng(4)
    s, h, kv, d = 24, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = rng.normal(size=(2, s, h, d)).astype(np.float32)
    k = rng.normal(size=(2, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(2, s, kv, d)).astype(np.float32)
    seg = np.repeat(np.array([[1, 2, 3], [1, 1, 2]], np.int32), 8, axis=1)
    pos = (np.arange(s, dtype=np.int32)[None] % 8).repeat(2, 0)
    want = JL._sdpa(cfg, *(jnp.asarray(a) for a in (q, k, v, pos, pos,
                                                    seg, seg)), causal=True)
    kernels.reset_path_stats()
    got = TL._sdpa(tcfg, *(torch.from_numpy(a) for a in (q, k, v, pos, pos,
                                                        seg, seg)),
                   causal=True)
    _close(got, want)
    assert kernels.path_stats()[("flash_attention", "reference")] == 1


# the dense archs: untied head; qkv biases; tied embeddings
@pytest.mark.parametrize("arch", [ARCH, "qwen1.5-32b", "command-r-35b"])
def test_apply_prefill_and_decode_match(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    rng = np.random.default_rng(0)
    tok = rng.integers(16, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jaux = japi.apply(jcfg, jp, {"tokens": jnp.asarray(tok)})
    tl, taux = tapi.apply(tcfg, tp, {"tokens": torch.from_numpy(tok)})
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    _close(tl, jl)
    _close(taux, jaux)
    jc, jlg = japi.prefill(jcfg, jp, jnp.asarray(tok))
    tc, tlg = tapi.prefill(tcfg, tp, torch.from_numpy(tok))
    _close(tlg, jlg)
    _close_to_scale(tc["k"], jc["k"])
    _close_to_scale(tc["v"], jc["v"])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    jc, tc = japi.pad_cache(jcfg, jc, 40), tapi.pad_cache(tcfg, tc, 40)
    assert tc["k"].shape == jc["k"].shape
    for _ in range(4):
        nxt = np.argmax(np.asarray(jlg), -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), nxt[:, 0])
        jlg, jc = japi.decode_step(jcfg, jp, jc, jnp.asarray(nxt))
        tlg, tc = tapi.decode_step(tcfg, tp, tc, torch.from_numpy(nxt))
        _close(tlg, jlg)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))
    _close_to_scale(tc["k"], jc["k"])


def test_apply_with_positions_takes_the_plain_path():
    jcfg, tcfg, jp, tp = _pair()
    rng = np.random.default_rng(1)
    tok = rng.integers(16, jcfg.vocab_size, (1, 16)).astype(np.int32)
    pos = (np.arange(16, dtype=np.int32) % 8)[None]
    seg = (np.arange(16, dtype=np.int32) // 8 + 1)[None]
    batch = {"tokens": tok, "positions": pos, "segment_ids": seg}
    jl, _ = japi.apply(jcfg, jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    kernels.reset_path_stats()
    tl, _ = tapi.apply(tcfg, tp, {k: torch.from_numpy(v) for k, v in
                                  batch.items()})
    _close(tl, jl)
    assert kernels.path_stats()[("flash_attention", "reference")] == \
        tcfg.num_layers


def test_cache_specs_match():
    jcfg, tcfg = j_smoke_config(ARCH), t_smoke_config(ARCH)
    js, jax_axes = japi.cache_specs(jcfg, 3, 64)
    ts, t_axes = tapi.cache_specs(tcfg, 3, 64)
    assert t_axes == jax_axes
    for key in js:
        assert ts[key].shape == js[key].shape
        assert str(ts[key].dtype) == f"torch.{js[key].dtype}"


# expert parallelism (moe_ep) in the moe and hybrid families is ported
# (models/moe_ep.py, held to repro over gloo ranks in
# test_torch_distributed.py): a moe_ep config has the same parameters as
# repro's, and without a mesh it computes moe_ffn's numbers; the moe, vlm,
# ssm, hybrid and encdec families themselves are held to repro in
# test_torch_families.py
@pytest.mark.parametrize("arch,moe_ep", [("olmoe-1b-7b", True),
                                         ("jamba-1.5-large-398b", True)])
def test_other_families_are_not_ported_yet(arch, moe_ep):
    cfg = t_smoke_config(arch).replace(moe_ep=moe_ep)
    jcfg = j_smoke_config(arch).replace(moe_ep=moe_ep)
    specs = tapi.param_specs(cfg)
    assert specs == tapi.param_specs(cfg.replace(moe_ep=False))
    assert tapi.param_count(cfg) == japi.param_count(jcfg)
    params = tapi.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(16, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    got = tapi.apply(cfg, params, {"tokens": tok})
    want = tapi.apply(cfg.replace(moe_ep=False), params, {"tokens": tok})
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_gelu_mlp_and_cross_attention_match():
    """whisper's layers on their own: the biased gelu MLP (jax.nn.gelu's
    tanh form) and cross-attention over seeded random encoder rows, its
    (k, v) for the cache, and the decode form that reuses them; the
    cross-attention takes the flash path (no plain-path dispatch)."""
    jcfg = j_smoke_config("whisper-medium")
    tcfg = t_smoke_config("whisper-medium")
    jp = japi.init_params(jcfg, jax.random.key(1))
    jl = jax.tree.map(lambda a: np.asarray(a)[0], jp["layers"])
    tl = params_from_numpy(jl, device="cpu")
    rng = np.random.default_rng(6)
    # non-zero biases, so that each is read where repro reads it
    for name in ("b_in", "b_out"):
        jl["mlp"][name] = rng.normal(size=jl["mlp"][name].shape).astype(
            np.float32)
        tl["mlp"][name] = torch.from_numpy(jl["mlp"][name])
    for name in ("bq", "bk", "bv"):
        jl["cross_attn"][name] = rng.normal(
            size=jl["cross_attn"][name].shape).astype(np.float32)
        tl["cross_attn"][name] = torch.from_numpy(jl["cross_attn"][name])
    x = rng.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    _close(TL.mlp(tcfg, tl["mlp"], torch.from_numpy(x)),
           JL.mlp(jcfg, jax.tree.map(jnp.asarray, jl["mlp"]),
                  jnp.asarray(x)))
    jxp = jax.tree.map(jnp.asarray, jl["cross_attn"])
    jy, (jk, jv) = JL.cross_attention(jcfg, jxp, jnp.asarray(x),
                                      jnp.asarray(enc))
    kernels.reset_path_stats()
    ty, (tk, tv) = TL.cross_attention(tcfg, tl["cross_attn"],
                                      torch.from_numpy(x),
                                      torch.from_numpy(enc))
    assert kernels.path_stats() == {}
    _close_to_scale(ty, jy)
    _close_to_scale(tk, jk)
    _close_to_scale(tv, jv)
    q = rng.normal(size=(2, 1, jcfg.num_heads, jcfg.head_dim)).astype(
        np.float32)
    _close_to_scale(
        TL.cross_attention_apply(tcfg, tl["cross_attn"], torch.from_numpy(q),
                                 tk, tv),
        JL.cross_attention_apply(jcfg, jxp, jnp.asarray(q), jk, jv))
