"""The port's moe, vlm, ssm, hybrid and encdec families on the CPU
against ``repro``'s: the same parameters (``repro``'s, carried across by
``params_from_numpy``) and the same numpy inputs through ``apply``,
``loss``, ``prefill``, ``decode_step`` and ``cache_specs`` of both
packages, and the MoE routing and the chunked SSD on their own.

Tolerances: float32 on both sides (the smoke configs).  The two packages
sum each matmul's products in other orders, and XLA's cumsum and
three-operand einsums associate differently from torch's, ~1e-6 relative
per op; TOL allows for that through a few layers.  Expert indices and
the kept masks are integers and bools: compared exactly.  The encdec
family (whisper) is fed seeded random frames, not the zero frontend, so
that its cross-attention is not uniform over the frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import api as japi
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.models import api as tapi
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models.params import (params_from_numpy, tree_flatten,
                                       tree_leaves)

ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b", "internvl2-2b", "mamba2-130m",
         "jamba-1.5-large-398b", "whisper-medium"]
TOL = 2e-5
# encdec: the decoder reads an encoder of its own depth over N(0, 1)
# frames, and its residual stream reaches ~20 where the logits stay
# below 1, so the logits keep ~5e-6 of the stream's relative error
# (measured at most 2.0e-5 of the largest |logit|); caches and hidden
# states stay within TOL of their own scale
FAMILY_TOL = {"encdec": 5e-5}


def _tol(cfg):
    return FAMILY_TOL.get(cfg.family, TOL)


def _pair(arch, **kw):
    jcfg = j_smoke_config(arch).replace(**kw)
    tcfg = t_smoke_config(arch).replace(**kw)
    jp = japi.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want, tol=TOL):
    """tol relative to the largest |want|: entries that cancel to ~0 keep
    the absolute error of their terms."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


def _close_tree(got, want, tol=TOL):
    leaves_j = jax.tree.leaves(want)
    leaves_t, _ = tree_flatten(got)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        assert tuple(a.shape) == b.shape
        _close(a, b, tol)


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(16, cfg.vocab_size, (b, s)).astype(np.int32)


def _frames(cfg, b, seed=0):
    """Seeded N(0, 1) frame embeddings for the encdec family, else None
    (the other families' default frontends)."""
    if cfg.family != "encdec":
        return None
    rng = np.random.default_rng(100 + seed)
    return rng.normal(size=(b, cfg.num_frontend_tokens, cfg.d_model)
                      ).astype(np.float32)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_match_in_jax_leaf_order(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    leaves_j, tdef = jax.tree.flatten(jp)
    leaves_t, struct = tree_flatten(tp)
    # the same leaves in JAX's sorted-key order: shapes, dtypes, values
    assert [tuple(x.shape) for x in leaves_t] == [x.shape for x in leaves_j]
    assert [str(x.dtype).replace("torch.", "") for x in leaves_t] == \
        [str(x.dtype) for x in leaves_j]
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    # full width, no tensor allocated
    from repro.configs import get_config
    assert tapi.param_count(t_get_config(arch)) == \
        japi.param_count(get_config(arch))
    shapes = tapi.param_shapes(tcfg)
    assert [tuple(x.shape) for x in tree_flatten(shapes)[0]] == \
        [x.shape for x in leaves_j]
    assert all(x.device.type == "meta" for x in tree_leaves(shapes))


def test_bf16_trees_keep_their_float32_leaves():
    """jamba's router, dt_bias, A_log, D and norms stay float32 inside a
    bf16 tree, in repro's init and the port's, and cross unchanged."""
    jcfg, tcfg, jp, tp = _pair("jamba-1.5-large-398b",
                               param_dtype="bfloat16")
    f32 = {"router", "dt_bias", "A_log", "D", "norm", "ln1", "ln2",
           "norm_f"}

    def dtypes(tree, prefix=()):
        if isinstance(tree, dict):
            return [x for k in sorted(tree)
                    for x in dtypes(tree[k], prefix + (k,))]
        return [(prefix[-1], str(tree.dtype).replace("torch.", ""))]
    want = dtypes(jax.tree.map(lambda a: a, jp))
    assert dtypes(tp) == want
    assert dtypes(tapi.init_params(tcfg, torch.Generator().manual_seed(0))
                  ) == want
    assert {n for n, d in want if d == "float32"} == f32
    assert {n for n, d in want if d == "bfloat16"}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match(arch):
    jcfg, tcfg = j_smoke_config(arch), t_smoke_config(arch)
    js, jax_axes = japi.cache_specs(jcfg, 3, 64)
    ts, t_axes = tapi.cache_specs(tcfg, 3, 64)
    assert t_axes == jax_axes
    jl, jdef = jax.tree.flatten(js)
    tl, _ = tree_flatten(ts)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        assert str(a.dtype) == f"torch.{b.dtype}"


def test_mamba_init_cache_matches():
    from repro.models import mamba_lm as JML
    from repro_torch.models import mamba_lm as TML
    jc = JML.init_cache(j_smoke_config("mamba2-130m"), 3)
    tc = TML.init_cache(t_smoke_config("mamba2-130m"), 3, "cpu")
    shapes, _ = tapi.cache_specs(t_smoke_config("mamba2-130m"), 3, 64)
    assert sorted(tc) == sorted(jc) == sorted(shapes)
    for key, want in jc.items():
        assert tuple(tc[key].shape) == want.shape == shapes[key].shape
        assert tc[key].dtype == shapes[key].dtype
        assert not tc[key].any() and not np.asarray(want).any()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_at_full_width(arch, shape):
    """repro's per-(arch x shape) stand-ins at the published config: the
    vlm frontend, its shorter token run, and each family's decode cache;
    nothing allocated."""
    from repro.configs import SHAPES, get_config
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    js, jaxes = japi.input_specs(jcfg, SHAPES[shape])
    ts, taxes = tapi.input_specs(tcfg, SHAPES[shape])
    assert taxes == jaxes
    jl, _ = jax.tree.flatten(js)
    tl, _ = tree_flatten(ts)
    assert [(tuple(a.shape), str(a.dtype)) for a in tl] == \
        [(b.shape, f"torch.{b.dtype}") for b in jl]


# ---------------------------------------------------------------------------
# whole models: apply, loss, prefill + decode
# ---------------------------------------------------------------------------

def _seq(cfg):
    """A prompt length both packages take: the SSD families need a
    multiple of their chunk (8) above one chunk."""
    return 16 if cfg.family in ("ssm", "hybrid") else 13


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_loss_match(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    s = _seq(jcfg)
    tok = _tokens(jcfg, 2, s)
    tgt = np.roll(tok, -1, axis=1)
    mask = (np.arange(s)[None] < s - 3).astype(np.float32).repeat(2, 0)
    fe = {} if jcfg.family != "encdec" else {"frontend": _frames(jcfg, 2)}
    jl, jaux = japi.apply(jcfg, jp, {"tokens": jnp.asarray(tok),
                                     **{k: jnp.asarray(v) for k, v in
                                        fe.items()}})
    tl, taux = tapi.apply(tcfg, tp, {"tokens": torch.from_numpy(tok),
                                     **{k: torch.from_numpy(v) for k, v in
                                        fe.items()}})
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    _close(tl, jl, _tol(jcfg))
    _close(taux, jaux)
    jb = {"tokens": tok, "targets": tgt, "loss_mask": mask, **fe}
    jtot, jm = japi.loss(jcfg, jp, {k: jnp.asarray(v) for k, v in
                                    jb.items()})
    ttot, tm = tapi.loss(tcfg, tp, {k: torch.from_numpy(v) for k, v in
                                    jb.items()})
    _close(ttot, jtot, _tol(jcfg))
    for key in ("loss", "aux", "tokens"):
        _close(tm[key], jm[key], _tol(jcfg))
    if jcfg.family in ("moe", "hybrid"):
        assert float(taux) > 0          # the MoE layers' balance loss


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_four_decode_steps_match(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    tok = _tokens(jcfg, 2, _seq(jcfg), seed=1)
    fe = _frames(jcfg, 2, seed=1)
    jc, jlg = japi.prefill(jcfg, jp, jnp.asarray(tok),
                           None if fe is None else jnp.asarray(fe))
    tc, tlg = tapi.prefill(tcfg, tp, torch.from_numpy(tok),
                           None if fe is None else torch.from_numpy(fe))
    _close(tlg, jlg, _tol(jcfg))
    _close_tree(tc, jc)
    jc, tc = japi.pad_cache(jcfg, jc, 40), tapi.pad_cache(tcfg, tc, 40)
    _close_tree(tc, jc)
    jstep = jax.jit(lambda p, c, t: japi.decode_step(jcfg, p, c, t))
    for _ in range(4):
        nxt = np.argmax(np.asarray(jlg), -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), nxt[:, 0])
        jlg, jc = jstep(jp, jc, jnp.asarray(nxt))
        tlg, tc = tapi.decode_step(tcfg, tp, tc, torch.from_numpy(nxt))
        _close(tlg, jlg, _tol(jcfg))
    _close_tree(tc, jc)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_vlm_frontend_positions_and_segments_match():
    """A given (non-zero) frontend, and explicit positions and segment ids
    that the frontend offsets; the frontend rows are trimmed."""
    jcfg, tcfg, jp, tp = _pair("internvl2-2b")
    rng = np.random.default_rng(2)
    tok = _tokens(jcfg, 2, 12, seed=2)
    fe = (rng.normal(size=(2, jcfg.num_frontend_tokens, jcfg.d_model))
          * 0.02).astype(np.float32)
    pos = (np.arange(12, dtype=np.int32) % 6)[None].repeat(2, 0)
    seg = (np.arange(12, dtype=np.int32) // 6 + 1)[None].repeat(2, 0)
    for batch in ({"tokens": tok, "frontend": fe},
                  {"tokens": tok, "frontend": fe, "positions": pos,
                   "segment_ids": seg}):
        jl, _ = japi.apply(jcfg, jp, {k: jnp.asarray(v) for k, v in
                                      batch.items()})
        tl, _ = tapi.apply(tcfg, tp, {k: torch.from_numpy(v) for k, v in
                                      batch.items()})
        assert tl.shape == (2, 12, jcfg.vocab_size)
        _close(tl, jl)
    jc, jlg = japi.prefill(jcfg, jp, jnp.asarray(tok), jnp.asarray(fe))
    tc, tlg = tapi.prefill(tcfg, tp, torch.from_numpy(tok),
                           torch.from_numpy(fe))
    _close(tlg, jlg)
    _close_tree(tc, jc)
    assert tc["len"].tolist() == [12 + jcfg.num_frontend_tokens] * 2
    assert tapi.token_len(tcfg, 64) == japi.token_len(jcfg, 64) == 56


# ---------------------------------------------------------------------------
# the MoE routing
# ---------------------------------------------------------------------------

def _repro_keep(idx, e, capacity):
    """repro's kept mask over its sorted pairs (moe.py:71-80), per group,
    and the sorted order."""
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    group_start = jnp.searchsorted(se, jnp.arange(e), side="left")
    pos = jnp.arange(flat_e.shape[0]) - group_start[se]
    return np.asarray(order), np.asarray(pos < capacity)


# (B, S, capacity_factor): the global layout (B*S <= 4096) at the config's
# factor and at one small enough that pairs drop; the per-row layout
# (B*S > 4096) likewise
MOE_CASES = [(2, 24, 1.25), (2, 24, 0.3), (2, 2056, 1.25), (2, 2056, 0.4)]


@pytest.mark.parametrize("b,s,cf", MOE_CASES)
def test_moe_routing_and_output_match(b, s, cf):
    jcfg, tcfg, jp, tp = _pair("olmoe-1b-7b", capacity_factor=cf)
    jl, tl = jp["layers"], tp["layers"]
    jmoe = jax.tree.map(lambda a: a[0], jl["moe"])
    tmoe = {k: v[0] for k, v in tl["moe"].items()}
    rng = np.random.default_rng(s)
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    # near-ties: some router logits equal, so the tie order is exercised
    x[:, ::5] = 0.0
    logits = np.array(jnp.einsum("bsd,de->bse", jnp.asarray(x),
                                   jmoe["router"]))
    jw, jidx = JM._route(jnp.asarray(logits), jcfg.experts_per_token)
    tw, tidx = TM._route(torch.from_numpy(logits), tcfg.experts_per_token)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw)
    glob = b * s <= TM._GLOBAL_ROUTE_MAX_TOKENS
    assert glob == (b * s <= JM._GLOBAL_ROUTE_MAX_TOKENS)
    cap = TM._capacity(tcfg, b * s if glob else s)
    assert cap == JM._capacity(jcfg, b * s if glob else s)
    groups = [np.asarray(jidx).reshape(1, b * s, -1)] if glob else \
        [np.asarray(jidx)[r:r + 1] for r in range(b)]
    t_groups = tidx.reshape(1, b * s, -1) if glob else tidx
    order, keep, _ = TM.expert_slots(t_groups, tcfg.num_experts, cap)
    dropped = 0
    for gi, g in enumerate(groups):
        j_order, j_keep = _repro_keep(jnp.asarray(g), jcfg.num_experts, cap)
        np.testing.assert_array_equal(order[gi].numpy(), j_order)
        np.testing.assert_array_equal(keep[gi].numpy(), j_keep)
        dropped += int((~j_keep).sum())
    if cf < 1:
        assert dropped > 0
    jy, jaux = JM.moe_ffn(jcfg, jmoe, jnp.asarray(x))
    ty, taux = TM.moe_ffn(tcfg, tmoe, torch.from_numpy(x))
    _close(ty, jy)
    _close(taux, jaux)


def test_route_breaks_ties_to_the_lower_expert():
    logits = torch.tensor([[0.5, 2.0, 2.0, 1.0, 2.0]])
    w, idx = TM._route(logits, 3)
    assert idx.tolist() == [[1, 2, 4]]
    jw, jidx = JM._route(jnp.asarray(logits.numpy()), 3)
    assert np.asarray(jidx).tolist() == idx.tolist()
    _close(w, jw)


# ---------------------------------------------------------------------------
# the chunked SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    a_log = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    st = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return xh, dt, bb, cc, a_log, st


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_over_four_chunks(init):
    cfg = t_smoke_config("mamba2-130m")
    jcfg = j_smoke_config("mamba2-130m")
    s = 4 * cfg.ssm_chunk
    xh, dt, bb, cc, a_log, st = _ssd_inputs(cfg, 2, s, 3)
    args = (xh, dt, bb, cc, a_log) + ((st,) if init else ())
    jy, js = JS.ssd_chunked(jcfg, *(jnp.asarray(a) for a in args))
    ty, ts = TS.ssd_chunked(cfg, *(torch.from_numpy(a) for a in args))
    _close(ty, jy)
    _close(ts, js)


def test_ssd_rejects_a_length_off_the_chunk():
    cfg = t_smoke_config("mamba2-130m")
    jcfg = j_smoke_config("mamba2-130m")
    args = _ssd_inputs(cfg, 1, cfg.ssm_chunk + 4, 4)[:5]
    with pytest.raises(AssertionError):
        JS.ssd_chunked(jcfg, *(jnp.asarray(a) for a in args))
    with pytest.raises(AssertionError):
        TS.ssd_chunked(cfg, *(torch.from_numpy(a) for a in args))
    # one chunk shorter than ssm_chunk is its own chunk
    short = _ssd_inputs(cfg, 1, 5, 4)[:5]
    _close(TS.ssd_chunked(cfg, *(torch.from_numpy(a) for a in short))[0],
           JS.ssd_chunked(jcfg, *(jnp.asarray(a) for a in short))[0])


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_recurrent_decode_continues_the_chunked_prefill(arch):
    """prefill(16) against prefill(8) + 8 decode steps (the invariant of
    test_arch_smoke.py's SSD test), both packages; and the port's own
    steps against repro's."""
    jcfg, tcfg, jp, tp = _pair(arch)
    tok = _tokens(jcfg, 1, 17, seed=4)
    _, full = tapi.prefill(tcfg, tp, torch.from_numpy(tok[:, :16]))
    tc, _ = tapi.prefill(tcfg, tp, torch.from_numpy(tok[:, :8]))
    jc, _ = japi.prefill(jcfg, jp, jnp.asarray(tok[:, :8]))
    tc, jc = tapi.pad_cache(tcfg, tc, 24), japi.pad_cache(jcfg, jc, 24)
    jstep = jax.jit(lambda p, c, t: japi.decode_step(jcfg, p, c, t))
    for i in range(8, 16):
        tlg, tc = tapi.decode_step(tcfg, tp, tc,
                                   torch.from_numpy(tok[:, i:i + 1]))
        jlg, jc = jstep(jp, jc, jnp.asarray(tok[:, i:i + 1]))
        _close(tlg, jlg)
    # repro's own tolerance for this invariant (test_arch_smoke.py)
    np.testing.assert_allclose(tlg.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
