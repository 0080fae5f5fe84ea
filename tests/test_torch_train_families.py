"""Training of every model family on the CPU against ``repro``'s: the
gradient of ``api.loss`` for every arch of ``ALL_ARCHS`` at smoke widths
(torch.autograd against ``jax.grad``, leaf by leaf), one AdamW step of
each family against ``repro``'s ``train_step``, and mamba2 at its
published chunk of 256.

Both packages get ``repro``'s parameters and the same numpy batch: 2
rows of 32 positions (the vlm family's tokens follow its 8 patch rows),
the second row's last 5 targets masked out, the vlm frontend seeded
N(0, 0.02²) patch rows, the encdec frontend seeded N(0, 1) frames (as
in ``test_torch_families.py``).

Tolerances (float32 on both sides).  Every gradient leaf within GRAD_TOL
of its own largest |value|: each package's float32 gradient lies up to
1.1e-4 of that scale from the float64 one (measured on these inputs, the
port in float64 against both: qwen1.5 jax 1.12e-4, torch 7.2e-5), and
the two packages' up to 1.03e-4 apart (jamba).  whisper's encoder is
ill-conditioned over N(0, 1) frames: each package lies 4.3e-4 (torch)
and 6.5e-4 (jax) from float64, so encdec gets 1e-3.  A leaf whose
largest reference |gradient| is below GRAD_FLOOR is zero up to rounding
(whisper's cross-attention ``bk``: softmax is invariant to a shift of
every key's score, largest 8.2e-9) and is held to |gradient| <=
GRAD_FLOOR on both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import smoke_config as j_smoke_config
from repro.models import api as japi
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.models import api as tapi
from repro_torch.models import ssm as TSSM
from repro_torch.models.params import (params_from_numpy, tree_flatten,
                                       tree_unflatten)
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

SEQ, BATCH = 32, 2
GRAD_TOL = 2e-4
FAMILY_GRAD_TOL = {"encdec": 1e-3}
GRAD_FLOOR = 1e-7
# one arch of each family takes an AdamW step
FAMILY_ARCHS = ["deepseek-coder-33b", "olmoe-1b-7b", "internvl2-2b",
                "mamba2-130m", "jamba-1.5-large-398b", "whisper-medium"]
OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=50, weight_decay=0.01)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    t = japi.token_len(cfg, SEQ)
    tok = rng.integers(16, cfg.vocab_size, (BATCH, t)).astype(np.int32)
    keep = np.array([[t], [t - 5]])
    batch = {"tokens": tok, "targets": np.roll(tok, -1, axis=1),
             "loss_mask": (np.arange(t)[None] < keep).astype(np.float32)}
    if cfg.family in ("vlm", "encdec"):
        scale = 0.02 if cfg.family == "vlm" else 1.0
        batch["frontend"] = (rng.normal(size=(
            BATCH, cfg.num_frontend_tokens, cfg.d_model)) * scale
        ).astype(np.float32)
    return batch


def _state(cfg, opt, seed=0):
    """repro's train state (its init at key(seed)) with non-zero moments,
    so that the update is a smooth function of the gradient."""
    st = jax.tree.map(np.asarray,
                      JS.init_train_state(cfg, opt, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    st["opt"]["m"] = jax.tree.map(
        lambda x: (rng.normal(size=x.shape) * 1e-3).astype(np.float32),
        st["opt"]["m"])
    st["opt"]["v"] = jax.tree.map(
        lambda x: (np.abs(rng.normal(size=x.shape)) * 1e-3
                   + 1e-6).astype(np.float32), st["opt"]["v"])
    st["step"] = np.asarray(3, np.int32)
    return st


@functools.lru_cache(maxsize=None)
def _repro(arch):
    """repro's loss, gradient, and one train_step from the same state, in
    one compiled program."""
    cfg = j_smoke_config(arch)
    jo = JO.OptConfig(**OPT_KW)
    state, batch = _state(cfg, jo), _batch(cfg)
    step = JS.make_train_step(cfg, jo)

    def both(st, b):
        (loss, _), grads = jax.value_and_grad(
            lambda p: japi.loss(cfg, p, b), has_aux=True)(st["params"])
        return loss, grads, step(st, b)
    loss, grads, (new, metrics) = jax.jit(both)(
        jax.tree.map(jnp.asarray, state), batch)
    return (state, batch, float(loss),
            [np.asarray(g) for g in jax.tree.leaves(grads)],
            jax.tree.map(np.asarray, new),
            {k: float(v) for k, v in metrics.items()})


def _tol(cfg):
    return FAMILY_GRAD_TOL.get(cfg.family, GRAD_TOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_gradient_of_the_loss_matches_repro(arch):
    cfg = t_smoke_config(arch)
    state, batch, jloss, jgrads, _, _ = _repro(arch)
    params = TS.state_from_numpy(state, device="cpu")["params"]
    flat, struct = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    loss, _ = tapi.loss(cfg, tree_unflatten(struct, leaves),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=2e-6)
    assert len(grads) == len(jgrads)
    tol = _tol(cfg)
    for i, (g, want) in enumerate(zip(grads, jgrads)):
        got = g.numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), i
        scale = np.abs(want).max()
        if scale < GRAD_FLOOR:
            assert np.abs(got).max() <= GRAD_FLOOR, (i, np.abs(got).max())
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                   err_msg=f"{arch} leaf {i}")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_adamw_step_matches_repro_train_step(arch):
    """TrainStep from repro's state: loss, grad_norm, lr and tokens, and
    every new parameter and moment (within 2e-5: the update's gradient
    terms carry the gradients' relative error times lr)."""
    cfg = t_smoke_config(arch)
    state, batch, _, _, jnew, jm = _repro(arch)
    new, m = TS.make_train_step(cfg, TO.OptConfig(**OPT_KW))(
        TS.state_from_numpy(state, device="cpu"), batch)
    tol = _tol(cfg)
    for key in ("loss", "aux", "tokens", "lr"):
        np.testing.assert_allclose(float(m[key]), jm[key], rtol=2e-6,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=tol)
    assert int(new["step"]) == int(jnew["step"]) == 4
    got = tree_flatten(new)[0]
    want = jax.tree.leaves(jnew)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)


def test_ssd_mask_before_exp_keeps_the_forward_bit_equal(monkeypatch):
    """At chunk 256 the decay's diff overflows exp above the diagonal.
    The port's mask-before-exp gives every value of repro's
    mask-after-exp form bit for bit (the whole forward too, with the
    port's own SSD run both ways), and agrees with repro's forward."""
    cfg = t_smoke_config("mamba2-130m").replace(ssm_chunk=256)
    jcfg = j_smoke_config("mamba2-130m").replace(ssm_chunk=256)
    rng = np.random.default_rng(3)
    tok = rng.integers(16, cfg.vocab_size, (1, 512)).astype(np.int32)
    jp = japi.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    batch = {"tokens": torch.from_numpy(tok)}
    new, _ = tapi.apply(cfg, tp, batch)

    # the intra-chunk decay of a real chunk of 256 overflows
    seen = {}
    orig = TSSM._decay

    def after(diff, tri):
        seen["overflow"] = bool(torch.isinf(torch.exp(diff)).any())
        want = torch.where(tri, torch.exp(diff), 0.0)
        assert torch.equal(orig(diff, tri), want)
        return want
    monkeypatch.setattr(TSSM, "_decay", after)
    old, _ = tapi.apply(cfg, tp, batch)
    assert seen["overflow"]
    assert torch.equal(new, old)
    # against repro: sums of 256 products in other orders, within 5e-5
    # of the largest |logit| (2e-5 at test_torch_families.py's chunk of 8)
    jl, _ = japi.apply(jcfg, jp, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(new.numpy(), np.asarray(jl), rtol=0,
                               atol=5e-5 * float(np.abs(jl).max()))


def test_ssd_gradient_is_finite_at_chunk_256():
    """The port's gradient of mamba2's loss at chunk 256 over 512 tokens
    is finite in every leaf (repro's is NaN in most, ROADMAP Queue 3), and
    equals the gradient at chunk 8 within GRAD_TOL (the same function,
    chunked differently), as repro's chunk-8 gradient does."""
    rng = np.random.default_rng(4)
    jcfg = j_smoke_config("mamba2-130m")
    tok = rng.integers(16, jcfg.vocab_size, (1, 512)).astype(np.int32)
    batch = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    jp = japi.init_params(jcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")

    def grads(cfg):
        flat, struct = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        loss, _ = tapi.loss(cfg, tree_unflatten(struct, leaves),
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
        return [g.numpy() for g in torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)]
    cfg = t_smoke_config("mamba2-130m")
    g256 = grads(cfg.replace(ssm_chunk=256))
    g8 = grads(cfg)
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(jcfg, p, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True))(jp)
    for a, b, c in zip(g256, g8, jax.tree.leaves(jg)):
        assert np.isfinite(a).all()
        scale = np.abs(c).max()
        np.testing.assert_allclose(a, c, rtol=0, atol=GRAD_TOL * scale)
        np.testing.assert_allclose(b, c, rtol=0, atol=GRAD_TOL * scale)
    # repro's own SSD at chunk 256: the same forward, NaN gradients
    (_, _), jg256 = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(jcfg.replace(ssm_chunk=256), p,
                            {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(jp)
    assert not all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(jg256))
