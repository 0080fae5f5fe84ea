"""The port's training slice on the CPU against ``repro``'s: the optimizer,
gradient compression, the chunked attention and cross-entropy, the whole
train step from one ``repro`` state, the stream packer and the LM data
plane, checkpoints crossing between the packages, and the trainer's
restart.  Both packages get the same numpy inputs from a seed, at
``smoke_config("deepseek-coder-33b")`` in float32 unless a test says
otherwise; each test states its tolerance."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RC
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.core import FeedManager, RefStore
from repro.core.enrich import queries as RQ
from repro.data.packing import StreamPacker as JPacker
from repro.kernels import dispatch_mode
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import transformer as JT
from repro.train import compression as JC
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro.train.data_feed import FeedDataSource as JFeedDataSource
from repro_torch import kernels
from repro_torch.ckpt import checkpoint as TC
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.configs.base import SHAPES as T_SHAPES
from repro_torch.core import FeedManager as TFeedManager
from repro_torch.core.refdata import refstore_from_numpy
from repro_torch.data.packing import StreamPacker as TPacker
from repro_torch.data.packing import pack_stream as t_pack_stream
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.train import compression as TCmp
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS
from repro_torch.train.data_feed import FeedDataSource as TFeedDataSource
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "deepseek-coder-33b"
JCFG, TCFG = j_smoke_config(ARCH), t_smoke_config(ARCH)
CPU = torch.device("cpu")
# float32 on both sides; sums and matmuls add in different orders
TOL = 2e-5


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _close_to_scale(got, want, tol=TOL):
    """tol of the largest |value|: gradients of sums of squares reach
    thousands, and an entry that cancels keeps its terms' error."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=tol,
        atol=tol * max(1.0, float(np.abs(want).max())))


def _tree_close(got, want, tol=TOL):
    """Every leaf of the port's tree (JAX order) against repro's."""
    gl, gs = TP.tree_flatten(got)
    wl, ws = jax.tree.flatten(want)
    assert TP.treedef_str(gs) == str(ws)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.float() if isinstance(g, torch.Tensor) else g,
               np.asarray(w, np.float32), tol)


def _jstate(seed=0, opt=None):
    """A repro train state with non-zero moments (so an update is a smooth
    function of the gradient, not its sign), as numpy."""
    opt = opt or JO.OptConfig()
    st = JS.init_train_state(JCFG, opt, jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def fill(x, positive=False):
        a = rng.normal(size=x.shape).astype(np.float32) * 1e-3
        return np.abs(a) + 1e-6 if positive else a
    st = jax.tree.map(np.asarray, st)
    st["opt"]["m"] = jax.tree.map(fill, st["opt"]["m"])
    st["opt"]["v"] = jax.tree.map(lambda x: fill(x, True), st["opt"]["v"])
    st["step"] = np.asarray(3, np.int32)
    return st


def _packed_batch(b=2, s=32, seed=0, vocab=None):
    """One packed batch (segments, positions, padding) from a seeded
    document stream."""
    rng = np.random.default_rng(seed)
    v = vocab or JCFG.vocab_size
    packer = JPacker(s, b)
    while True:
        doc = rng.integers(16, v, int(rng.integers(3, s // 2))).tolist()
        out = packer.add(doc)
        if out is not None:
            return out


# ---------------------------------------------------------------------------
# tree order, specs
# ---------------------------------------------------------------------------

def test_tree_flatten_is_jax_order():
    jp = japi.init_params(JCFG, jax.random.key(0))
    tp = TP.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tl, ts = TP.tree_flatten(tp)
    jl, jd = jax.tree.flatten(jp)
    assert TP.treedef_str(ts) == str(jd)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = TP.tree_unflatten(ts, tl)
    assert [id(x) for x in TP.tree_flatten(back)[0]] == [id(x) for x in tl]
    assert TP.tree_flatten_up_to(ts, tp) == tl


def test_param_shapes_axes_bytes_match():
    js, ts = japi.param_shapes(JCFG), tapi.param_shapes(TCFG)
    assert all(x.device.type == "meta" for x in TP.tree_leaves(ts))
    jl, jd = jax.tree.flatten(js)
    tl, tstruct = TP.tree_flatten(ts)
    assert TP.treedef_str(tstruct) == str(jd)
    assert [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in tl] == [(a.shape, str(a.dtype)) for a in jl]
    is_ax = lambda x: isinstance(x, tuple)  # noqa: E731
    assert (jax.tree.leaves(japi.param_axes(JCFG), is_leaf=is_ax)
            == TP.tree_flatten(tapi.param_axes(TCFG))[0])
    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get_config
    full_j, full_t = get_config(ARCH), t_get_config(ARCH)
    assert (TP.param_bytes(tapi.param_specs(full_t), full_t.param_dtype)
            == JP.param_bytes(japi.param_specs(full_j), full_j.param_dtype))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_and_zero_inputs_match(shape):
    js, jax_axes = japi.input_specs(JCFG, J_SHAPES[shape])
    ts, t_axes = tapi.input_specs(TCFG, T_SHAPES[shape])
    assert t_axes == jax_axes
    jl = jax.tree.leaves(js)
    tl = TP.tree_flatten(ts)[0]
    assert [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in tl] == [(a.shape, str(a.dtype)) for a in jl]
    assert tapi.token_len(TCFG, 4096) == japi.token_len(JCFG, 4096)
    if shape == "train_4k":
        small = T_SHAPES[shape].__class__("t", 16, 2, "train")
        z = tapi.make_zero_inputs(TCFG, small, device="cpu")
        assert z["tokens"].shape == (2, 16) and not z["tokens"].any()


def test_train_state_shapes_and_axes_match():
    opt_j = JO.OptConfig(factored_v=True, state_dtype="bfloat16")
    opt_t = TO.OptConfig(factored_v=True, state_dtype="bfloat16")
    js, ts = JS.train_state_shapes(JCFG, opt_j), TS.train_state_shapes(
        TCFG, opt_t)
    jl, jd = jax.tree.flatten(js)
    tl, tstruct = TP.tree_flatten(ts)
    assert TP.treedef_str(tstruct) == str(jd)
    assert all(x.device.type == "meta" for x in tl)
    assert [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in tl] == [(a.shape, str(a.dtype)) for a in jl]
    is_ax = lambda x: isinstance(x, tuple)  # noqa: E731
    assert (jax.tree.leaves(JS.train_state_axes(JCFG, opt_j), is_leaf=is_ax)
            == TP.tree_flatten(TS.train_state_axes(TCFG, opt_t))[0])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 2, 5, 49, 50, 99, 120])
def test_schedule_matches(step):
    jo = JO.OptConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    to = TO.OptConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    want = JO.schedule(jo, jnp.asarray(step, jnp.int32))
    got = TO.schedule(to, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    # float32 on both sides: within 2 ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-7)


# bf16 moments are rounded from float32 values that the two packages may
# compute an ulp apart: one bf16 ulp (2^-8 relative)
@pytest.mark.parametrize("factored,state_dtype,tol", [
    (False, "float32", TOL), (True, "float32", TOL),
    (False, "bfloat16", 2 ** -7), (True, "bfloat16", 2 ** -7)])
def test_adamw_update_matches(factored, state_dtype, tol):
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50, weight_decay=0.1,
              factored_v=factored, state_dtype=state_dtype, grad_clip=0.5)
    jo, to = JO.OptConfig(**kw), TO.OptConfig(**kw)
    params = jax.tree.map(np.asarray,
                          japi.init_params(JCFG, jax.random.key(1)))
    rng = np.random.default_rng(2)
    grads = jax.tree.map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    jopt = jax.tree.map(np.asarray, JO.adamw_init(jo, params))
    jopt = jax.tree.map(
        lambda x: (np.abs(rng.normal(size=x.shape)) * 1e-2 + 1e-4)
        .astype(np.float32).astype(x.dtype), jopt)
    step = 4
    jp, jst, jm = JO.adamw_update(jo, params, grads, jopt,
                                  jnp.asarray(step, jnp.int32))
    tparams = TP.params_from_numpy(params, device="cpu")
    topt = TS.state_from_numpy(jopt, device="cpu")
    tp, tst, tm = TO.adamw_update(
        to, tparams, TP.params_from_numpy(grads, device="cpu"), topt,
        torch.tensor(step, dtype=torch.int32))
    assert tp is tparams and tst is topt          # updated in place
    _close(tm["grad_norm"], jm["grad_norm"])
    _close(tm["lr"], jm["lr"])
    _tree_close(tp, jp)
    _tree_close(tst, jst, tol)
    if state_dtype == "bfloat16":
        assert tst["m"]["embed"]["tok"].dtype == torch.bfloat16


def test_adamw_init_structure_matches():
    for factored in (False, True):
        jo = JO.OptConfig(factored_v=factored)
        to = TO.OptConfig(factored_v=factored)
        params = japi.init_params(JCFG, jax.random.key(0))
        js = JO.adamw_init(jo, params)
        ts = TO.adamw_init(to, TP.params_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu"))
        jl, jd = jax.tree.flatten(js)
        tl, tstruct = TP.tree_flatten(ts)
        assert TP.treedef_str(tstruct) == str(jd)
        assert [tuple(x.shape) for x in tl] == [x.shape for x in jl]


# ---------------------------------------------------------------------------
# gradient compression: int8 values and scales bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(300,), (17, 5), (256,), (3, 256, 2)])
def test_quantize_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    g = rng.normal(size=shape).astype(np.float32)
    g.reshape(-1)[:3] = [0.5, -0.5, 1.5]           # ties at the scale
    jq, js = JC.quantize(jnp.asarray(g))
    tq, ts = TCmp.quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TCmp.dequantize(tq, ts, shape, g.size).numpy(),
        np.asarray(JC.dequantize(jq, js, shape, g.size)))


def test_quantize_rounds_half_to_even():
    # a block whose max is 127 has scale 1: x.5 rounds to the even int
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 250,
                 np.float32)
    tq, _ = TCmp.quantize(torch.from_numpy(g))
    assert tq[0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    np.testing.assert_array_equal(tq.numpy(),
                                  np.asarray(JC.quantize(jnp.asarray(g))[0]))


def test_compress_tree_matches():
    rng = np.random.default_rng(0)
    g = {"b": rng.normal(size=(17, 5)).astype(np.float32),
         "a": rng.normal(size=(300,)).astype(np.float32)}
    e = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-2
         for k, v in g.items()}
    jc, je = JC.compress_tree(jax.tree.map(jnp.asarray, g),
                              jax.tree.map(jnp.asarray, e))
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    tc, te = TCmp.compress_tree(tg, {k: torch.from_numpy(v)
                                     for k, v in e.items()})
    for k in g:
        np.testing.assert_array_equal(tc[k][0].numpy(), np.asarray(jc[k][0]))
        np.testing.assert_array_equal(tc[k][1].numpy(), np.asarray(jc[k][1]))
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
    jd = JC.decompress_tree(jc, jax.tree.map(jnp.asarray, g))
    td = TCmp.decompress_tree(tc, tg)
    for k in g:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    z = TCmp.init_error(tg)
    assert all(not z[k].any() and z[k].dtype == torch.float32 for k in z)


# ---------------------------------------------------------------------------
# attention and cross-entropy: forward and gradient
# ---------------------------------------------------------------------------

def _attn_inputs(s, seed, padded=True):
    """q, k, v for the smoke heads and one packed row per batch entry:
    documents of 20-90 tokens, positions restarting per document, and
    padding (segment 0, position 0) at the end of the second row."""
    rng = np.random.default_rng(seed)
    h, kv, d = JCFG.num_heads, JCFG.num_kv_heads, JCFG.resolved_head_dim
    q = rng.normal(size=(2, s, h, d)).astype(np.float32)
    k = rng.normal(size=(2, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(2, s, kv, d)).astype(np.float32)
    seg = np.zeros((2, s), np.int32)
    pos = np.zeros((2, s), np.int32)
    for b in range(2):
        cur, sid = 0, 1
        end = s - (s // 5 if (padded and b == 1) else 0)
        while cur < end:
            n = min(int(rng.integers(20, 90)), end - cur)
            seg[b, cur:cur + n] = sid
            pos[b, cur:cur + n] = np.arange(n)
            cur, sid = cur + n, sid + 1
    return q, k, v, pos, seg


@pytest.mark.parametrize("s,with_seg", [(256, True), (256, False),
                                        (512, True)])
def test_chunked_gqa_forward_and_grad_match(s, with_seg):
    q, k, v, pos, seg = _attn_inputs(s, s)
    qb = kb = TL._pick_block(s)
    assert qb == JL._pick_block(s) and qb is not None and qb < s
    rng = np.random.default_rng(1)
    w = rng.normal(size=q.shape).astype(np.float32)   # d loss / d out

    def jloss(q, k, v):
        o = JL._chunked_gqa(JCFG, q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                            jnp.asarray(seg) if with_seg else None,
                            jnp.asarray(seg) if with_seg else None,
                            qb, kb, True)
        return jnp.sum(o * w), o
    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ts = torch.from_numpy(seg) if with_seg else None
    to = TL._chunked_gqa(TCFG, tq, tk, tv, torch.from_numpy(pos),
                         torch.from_numpy(pos), ts, ts, qb, kb, True)
    (to * torch.from_numpy(w)).sum().backward()
    _close(to, jo)
    assert bool(torch.isfinite(to).all())
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, want, 1e-4)


def test_attention_with_packed_segments_matches_with_grad():
    """The layer (projections, RoPE, chunked attention) with packed
    segments and positions: output and every parameter's gradient."""
    s = 256
    jp = japi.init_params(JCFG, jax.random.key(3))
    attn = jax.tree.map(lambda x: x[0], jp["layers"]["attn"])
    _, _, _, pos, seg = _attn_inputs(s, 7)
    x = np.random.default_rng(8).normal(
        size=(2, s, JCFG.d_model)).astype(np.float32)

    def jloss(p, x):
        o = JL.attention(JCFG, p, x, jnp.asarray(pos), jnp.asarray(seg))
        return jnp.sum(o ** 2), o
    (_, jo), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(attn, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in attn.items()}
    tx = torch.from_numpy(x).requires_grad_()
    kernels.reset_path_stats()
    to = TL.attention(TCFG, tp, tx, torch.from_numpy(pos),
                      torch.from_numpy(seg))
    (to ** 2).sum().backward()
    assert kernels.path_stats() == {("flash_attention", "reference"): 1}
    _close_to_scale(to, jo)
    _close_to_scale(tx.grad, jgx)
    for k in tp:
        _close_to_scale(tp[k].grad, jgp[k])


def test_training_attention_never_calls_the_forward_only_kernel(monkeypatch):
    """With a card pretended (``on_cuda`` patched true) and the kernel
    replaced by a recorder: under grad mode with inputs that require grad
    the attention takes the chunked path, noted "plain_on_card", and
    gets a gradient; without grad it takes the kernel, as serving does."""
    calls = []

    def kernel(q, k, v, causal=True):
        calls.append(q.shape)
        return torch.zeros_like(q)
    monkeypatch.setattr(TL, "on_cuda", lambda t: True)
    monkeypatch.setattr(fa_ops, "flash_attention", kernel)
    rng = np.random.default_rng(0)
    h, kv, d = TCFG.num_heads, TCFG.num_kv_heads, TCFG.resolved_head_dim
    q = torch.from_numpy(rng.normal(size=(1, 256, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 256, kv, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 256, kv, d)).astype(np.float32))
    kernels.reset_path_stats()
    qg = q.clone().requires_grad_()
    out = TL._sdpa(TCFG, qg, k, v, None, None, None, None, True)
    out.sum().backward()
    assert calls == []
    assert kernels.path_stats() == {("flash_attention", "plain_on_card"): 1}
    assert qg.grad is not None and bool(qg.grad.abs().sum() > 0)
    with torch.no_grad():
        TL._sdpa(TCFG, qg, k, v, None, None, None, None, True)
    TL._sdpa(TCFG, q, k, v, None, None, None, None, True)   # no grad needed
    assert len(calls) == 2
    assert kernels.path_stats() == {("flash_attention", "plain_on_card"): 1}


def test_flash_kernel_refuses_inputs_that_require_grad():
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    q = torch.zeros(1, 8, 4, 16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa_kernel.flash_attention(q, k, k)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, k)        # past the check


@pytest.mark.parametrize("s", [1024, 32])     # chunked, not chunked
def test_chunked_xent_matches_with_grad(s):
    jp = japi.init_params(JCFG, jax.random.key(4))
    rng = np.random.default_rng(s)
    hidden = rng.normal(size=(2, s, JCFG.d_model)).astype(np.float32)
    tgt = rng.integers(0, JCFG.vocab_size, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) < 0.8).astype(np.float32)

    def jloss(e, h):
        ce, denom = JT.chunked_xent(JCFG, e, h, jnp.asarray(tgt),
                                    jnp.asarray(mask))
        return ce, denom
    (jce, jden), (jge, jgh) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp["embed"], jnp.asarray(hidden))
    te = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp["embed"].items()}
    th = torch.from_numpy(hidden).requires_grad_()
    tce, tden = TT.chunked_xent(TCFG, te, th, torch.from_numpy(tgt),
                                torch.from_numpy(mask))
    tce.backward()
    _close(tce, jce)
    assert float(tden) == float(jden)
    _close(th.grad, jgh)
    _close(te["head"].grad, jge["head"])
    # the untied head is the only embedding leaf the loss reads
    assert te["tok"].grad is None and not np.asarray(jge["tok"]).any()


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_the_same_gradients(remat):
    """remat changes what backward saves, not what it computes."""
    cfg = TCFG.replace(remat=remat)
    params = TP.params_from_numpy(jax.tree.map(
        np.asarray, japi.init_params(JCFG, jax.random.key(5))), device="cpu")
    batch = TS.batch_to(_packed_batch(s=256), CPU)
    step_none = TS.make_train_step(TCFG, TO.OptConfig())
    step_remat = TS.make_train_step(cfg, TO.OptConfig())
    l0, _, g0 = step_none.accumulate(params, batch)
    l1, _, g1 = step_remat.accumulate(params, batch)
    assert float(l0) == float(l1)
    for a, b in zip(TP.tree_flatten(g0)[0], TP.tree_flatten(g1)[0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the whole train step from one repro state
# ---------------------------------------------------------------------------

# S = 1,024 with remat="full": both the attention and the cross-entropy
# chunk, and every layer is checkpointed on both sides
@pytest.mark.parametrize("microbatches,s,remat", [(1, 32, "none"),
                                                  (2, 32, "none"),
                                                  (1, 1024, "full")])
def test_train_step_matches_repro(microbatches, s, remat):
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50, weight_decay=0.01)
    jo, to = JO.OptConfig(**kw), TO.OptConfig(**kw)
    jcfg, tcfg = JCFG.replace(remat=remat), TCFG.replace(remat=remat)
    jstate = _jstate(0, jo)
    batch = _packed_batch(b=4 if s == 32 else 2, s=s)
    tstate = TS.state_from_numpy(jstate, device="cpu")
    jnew, jm = jax.jit(JS.make_train_step(jcfg, jo, microbatches))(
        jax.tree.map(jnp.asarray, jstate), batch)
    kernels.reset_path_stats()
    tnew, tm = TS.make_train_step(tcfg, to, microbatches)(tstate, batch)
    assert set(tm) == set(jm)
    for key in ("loss", "grad_norm", "lr", "tokens", "aux"):
        _close(tm[key], jm[key])
    assert tnew["step"].dtype == torch.int32 and tnew["step"].dim() == 0
    assert int(tnew["step"]) == int(jnew["step"]) == 4
    _tree_close(tnew, jax.tree.map(np.asarray, jnew))
    back = TS.state_to_numpy(tnew)
    assert back["params"]["embed"]["tok"].dtype == np.float32
    # packed segments: every layer's attention took the plain path (once
    # more per layer where backward recomputes a checkpointed layer)
    passes = 2 if remat == "full" else 1
    assert kernels.path_stats() == {("flash_attention", "reference"):
                                    microbatches * TCFG.num_layers * passes}


def test_train_step_bf16_state_round_trips_through_numpy():
    cfg = TCFG.replace(param_dtype="bfloat16", dtype="bfloat16")
    st = TS.init_train_state(cfg, TO.OptConfig(),
                             torch.Generator().manual_seed(0))
    back = TS.state_from_numpy(TS.state_to_numpy(st), device="cpu")
    for a, b in zip(TP.tree_flatten(st)[0], TP.tree_flatten(back)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    new, m = TS.make_train_step(cfg, TO.OptConfig(warmup_steps=0))(
        back, _packed_batch(s=32))
    assert np.isfinite(float(m["loss"])) and int(new["step"]) == 1
    assert new["params"]["layers"]["attn"]["wq"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# packing and the LM data plane
# ---------------------------------------------------------------------------

def _docs(n, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(16, vocab, int(rng.integers(1, 50))).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("seq_len,batch", [(32, 2), (64, 3), (16, 1)])
def test_stream_packer_bit_equal(seq_len, batch):
    from repro.data.packing import pack_stream as j_pack_stream
    docs = _docs(200, seq_len)
    want = list(j_pack_stream(iter(docs), seq_len, batch))
    got = list(t_pack_stream(iter(docs), seq_len, batch))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    tp, jp = TPacker(seq_len, batch), JPacker(seq_len, batch)
    for d in docs[:7]:
        a, b = tp.add(d), jp.add(d)
        assert (a is None) == (b is None)


@pytest.fixture(scope="module")
def lm_stores():
    s = RefStore()
    RQ.make_reference_tables(s, scale=0.002, seed=7)
    tables = {name: s[name].snapshot().arrays
              for name in RQ.PAPER_CARDINALITIES}
    return s, refstore_from_numpy(tables)


def _feed_batches(src):
    return list(iter(src))


def _feed_pair(stores, partitions):
    kw = dict(vocab_size=JCFG.vocab_size, seq_len=32, batch_size=2,
              total_records=1200, frame_size=128, safety_filter=True,
              num_partitions=partitions, seed=3)
    with dispatch_mode("reference"):
        jsrc = JFeedDataSource(FeedManager(stores[0]), **kw)
        jb = _feed_batches(jsrc)
    tsrc = TFeedDataSource(TFeedManager(stores[1], device="cpu"), **kw)
    tb = _feed_batches(tsrc)
    assert jsrc.filtered == tsrc.filtered
    return jb, tb


def _documents(batches):
    out = []
    for b in batches:
        for i in range(b["tokens"].shape[0]):
            for seg in np.unique(b["segment_ids"][i]):
                if seg:
                    out.append(tuple(b["tokens"][i][
                        b["segment_ids"][i] == seg].tolist()))
    return sorted(out)


def test_feed_data_source_one_partition_bit_equal(lm_stores):
    jb, tb = _feed_pair(lm_stores, 1)
    assert len(tb) == len(jb) > 5
    for g, w in zip(tb, jb):
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_feed_data_source_two_partitions_same_documents(lm_stores):
    jb, tb = _feed_pair(lm_stores, 2)
    docs = _documents(tb)
    assert len(docs) > 100 and docs == _documents(jb)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _manifest(path):
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)


def test_checkpoint_from_repro_restores_in_the_port(tmp_path):
    jstate = jax.tree.map(jnp.asarray, _jstate(1))
    RC.save(str(tmp_path), 7, jstate)
    like = TS.state_from_numpy(jax.tree.map(np.zeros_like,
                                            _jstate(2)), device="cpu")
    back = TC.restore(str(tmp_path), like)
    assert TC.latest_step(str(tmp_path)) == 7
    bl, _ = TP.tree_flatten(back)
    jl = jax.tree.leaves(jstate)
    assert len(bl) == len(jl)
    for a, b in zip(bl, jl):
        assert a.dtype == TP.torch_dtype(str(b.dtype))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_checkpoint_from_the_port_restores_in_repro(tmp_path):
    np_state = _jstate(3)
    tstate = TS.state_from_numpy(np_state, device="cpu")
    tpath = TC.save(str(tmp_path / "t"), 5, tstate)
    jpath = RC.save(str(tmp_path / "j"), 5,
                    jax.tree.map(jnp.asarray, np_state))
    assert _manifest(tpath) == _manifest(jpath)
    for name in sorted(os.listdir(jpath)):
        with open(os.path.join(tpath, name), "rb") as a, \
                open(os.path.join(jpath, name), "rb") as b:
            assert a.read() == b.read(), name
    back = RC.restore(str(tmp_path / "t"), jax.tree.map(jnp.asarray,
                                                        np_state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_state)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bf16_checkpoint_round_trips_in_the_port(tmp_path):
    cfg = TCFG.replace(param_dtype="bfloat16", dtype="bfloat16")
    st = TS.init_train_state(cfg, TO.OptConfig(state_dtype="bfloat16"),
                             torch.Generator().manual_seed(1))
    path = TC.save(str(tmp_path / "t"), 2, st)
    back = TC.restore(str(tmp_path / "t"), TS.train_state_shapes(
        cfg, TO.OptConfig(state_dtype="bfloat16")), device="cpu")
    for a, b in zip(TP.tree_flatten(st)[0], TP.tree_flatten(back)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the same bytes and header as repro's save of the same values
    wq = st["params"]["layers"]["attn"]["wq"]
    jwq = jnp.asarray(wq.float().numpy(), jnp.bfloat16)
    jpath = RC.save(str(tmp_path / "j"), 2, {"w": jwq})
    tpath = TC.save(str(tmp_path / "t1"), 2, {"w": wq})
    assert _manifest(tpath) == _manifest(jpath)
    assert _manifest(tpath)["leaves"][0]["dtype"] == "<V2"
    with open(os.path.join(tpath, "leaf_00000.npy"), "rb") as a, \
            open(os.path.join(jpath, "leaf_00000.npy"), "rb") as b:
        assert a.read() == b.read()
    assert path.endswith("step_00000002")


def test_checkpoint_detects_corruption(tmp_path):
    state = {"w": torch.arange(10, dtype=torch.float32)}
    path = TC.save(str(tmp_path), 1, state)
    leaf = os.path.join(path, "leaf_00000.npy")
    arr = np.load(leaf)
    arr[0] = 999
    np.save(leaf, arr)
    with pytest.raises(IOError, match="checksum"):
        TC.restore(str(tmp_path), state)


def test_checkpoint_retention_keeps_k(tmp_path):
    state = {"w": torch.ones(3), "step": torch.zeros((), dtype=torch.int32)}
    for s in (1, 2, 3, 4, 5):
        TC.save(str(tmp_path), s, state, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000005"]
    assert sorted(TC.all_steps(str(tmp_path))) == [4, 5]
    os.makedirs(tmp_path / "step_00000009.tmp")  # an uncommitted save
    assert TC.latest_step(str(tmp_path)) == 5


# ---------------------------------------------------------------------------
# the trainer and the launcher
# ---------------------------------------------------------------------------

def _batches(n, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        t = rng.integers(3, JCFG.vocab_size, (b, s)).astype(np.int32)
        yield {"tokens": t, "targets": np.roll(t, -1, 1)}


def test_trainer_resumes_after_injected_failure(tmp_path):
    opt = TO.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50,
                       weight_decay=0.01)
    tcfg = TrainerConfig(steps=12, ckpt_dir=str(tmp_path), ckpt_every=4,
                         log_every=1, max_restarts=2)
    trainer = Trainer(TCFG, opt, tcfg, device="cpu")
    fails = {"left": 1}
    seen = []

    def fault_hook(step):
        seen.append(step)
        if step == 6 and fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("injected node failure")

    hist = trainer.run(_batches(100), fault_hook=fault_hook)
    assert trainer.restarts == 1
    assert int(trainer.state["step"]) == 12
    # resumed from the step-4 checkpoint: steps 4 and 5 ran twice, no
    # other step did
    assert seen == list(range(7)) + list(range(4, 12))
    assert [h["step"] for h in hist][-1] == 12
    assert len(trainer.step_times) == 12 + 2
    assert all(t["grad_s"] > 0 and t["update_s"] > 0
               for t in trainer.step_times)
    assert TC.latest_step(str(tmp_path)) == 12
    # a new trainer over the same directory starts where this one ended
    again = Trainer(TCFG, opt, tcfg, device="cpu")
    assert int(again.state["step"]) == 12
    for a, b in zip(TP.tree_flatten(again.state)[0],
                    TP.tree_flatten(trainer.state)[0]):
        assert torch.equal(a, b)


def test_trainer_fed_by_the_lm_data_plane(lm_stores):
    src = TFeedDataSource(TFeedManager(lm_stores[1], device="cpu"),
                          vocab_size=TCFG.vocab_size, seq_len=32,
                          batch_size=2, total_records=3000, frame_size=128,
                          safety_filter=True, num_partitions=2)
    trainer = Trainer(TCFG, TO.OptConfig(lr=1e-3, warmup_steps=2),
                      TrainerConfig(steps=5, log_every=1), device="cpu")
    try:
        hist = trainer.run(iter(src))
    finally:
        src.close()
    assert int(trainer.state["step"]) == 5
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(TCFG, TO.OptConfig(), TrainerConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.state_from_numpy({"w": np.zeros(2)})


def test_launch_train_smoke_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": "src"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--steps", "4", "--seq-len", "32", "--batch", "2",
           "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every",
           "2"]
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "step     4" in proc.stdout
    assert TC.latest_step(str(tmp_path)) == 4
    bad = subprocess.run(cmd + ["--model-parallel", "2"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "--model-parallel" in bad.stderr
