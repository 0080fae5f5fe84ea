"""The MoE and hybrid families (olmoe, kimi, jamba) on repro's production
layout, against repro: MoE routing in forms DTensor can place, the train
state's placements, a production step on a 2 x 2 gloo mesh, and a dry-run
cell end to end.

Tolerances: integers and bools (expert choices, the sorted order, kept
pairs, buffer slots) are compared exactly, with dtypes and shapes, and the
new routing's output bit for bit against the old forms on the same
inputs.  Against repro's ``_dispatch_combine`` (another package, another
summation order) float32 outputs agree within 1e-5 of their largest
|value|.  The 2 x 2 step is held to repro's jitted one-device step within
the production layout's limits (``PROD_METRIC_RTOL``; every new leaf
within 2e-5 + 2e-5 |x|), after its routing is shown to be repro's: every
token's gap between its k-th and (k+1)-th router logit exceeds the
largest difference between the two packages' logits."""

import importlib.util
import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.ckpt import checkpoint as RC
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models import api as japi
from repro.models import moe as JM
from repro.models import sharding as JSH
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.launch.mesh import production_layout
from repro_torch.models import moe as TM
from repro_torch.models.params import tree_flatten
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MOE_ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"]


# ---------------------------------------------------------------------------
# (i) the routing forms against the old ones and against repro's
# ---------------------------------------------------------------------------

def _old_expert_slots(idx, num_experts, capacity):
    """``expert_slots`` before it ran under DTensor (searchsorted)."""
    g, t, k = idx.shape
    tk = t * k
    flat_e = idx.reshape(g, tk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    experts = torch.arange(num_experts, device=idx.device)
    group_start = torch.searchsorted(
        se, experts.expand(g, num_experts).contiguous(), side="left")
    pos = (torch.arange(tk, device=idx.device)
           - torch.gather(group_start, 1, se))
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, num_experts * capacity)
    return order, keep, slot


def _old_dispatch_combine(cfg, p, x, weights, idx, capacity):
    """``_dispatch_combine`` before it ran under DTensor (the buffer and
    the inverse permutation by ``scatter_``)."""
    g, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tk = t * k
    order, keep, slot = _old_expert_slots(idx, e, capacity)
    st = order // k
    buf = x.new_zeros((g, e * capacity + 1, d))
    buf.scatter_(1, slot[..., None].expand(g, tk, d),
                 torch.gather(x, 1, st[..., None].expand(g, tk, d)))
    xe = buf[:, :-1].reshape(g, e, capacity, d).transpose(0, 1).reshape(
        e, g * capacity, d)
    h = (F.silu(torch.bmm(xe, p["w_gate"].to(x.dtype)))
         * torch.bmm(xe, p["w_up"].to(x.dtype)))
    out = torch.bmm(h, p["w_down"].to(x.dtype))
    out = out.reshape(e, g, capacity, d).transpose(0, 1).reshape(
        g, e * capacity, d)
    out = torch.cat([out, out.new_zeros((g, 1, d))], dim=1)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(tk, device=x.device).expand(g, tk))
    by_e = torch.argsort(idx, dim=-1)
    slot_t, keep_t = (torch.gather(torch.gather(a, 1, inv).reshape(g, t, k),
                                   2, by_e) for a in (slot, keep))
    coef = (torch.gather(weights, 2, by_e) * keep_t).to(out.dtype)
    gathered = torch.gather(
        out, 1, slot_t.reshape(g, tk, 1).expand(g, tk, d)).reshape(
            g, t, k, d) * coef[..., None]
    y = torch.zeros((g, t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + gathered[:, :, j]
    return y


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


# (arch, groups, tokens a group, capacity factor, activation dtype): one
# global group at the config's factor and at one where most pairs drop,
# per-row groups, kimi's 384 experts and 8 choices at reduced T, jamba's
# 16 experts and 2 choices
ROUTE_CASES = [
    ("olmoe-1b-7b", 1, 512, 1.25, "float32"),
    ("olmoe-1b-7b", 1, 512, 0.3, "float32"),
    ("olmoe-1b-7b", 3, 300, 1.25, "float32"),
    ("kimi-k2-1t-a32b", 2, 256, 1.25, "bfloat16"),
    ("jamba-1.5-large-398b", 2, 160, 1.25, "bfloat16"),
    ("jamba-1.5-large-398b", 4, 96, 0.5, "float32"),
]


def _route_inputs(arch, g, t, cf, dtype, d=32, f=16):
    """Seeded numpy inputs: expert weights, activations and router logits
    with every fourth token's logits rounded to integers (ties, which go
    to the lower expert)."""
    cfg = t_get_config(arch).replace(d_model=d, d_ff=f, capacity_factor=cf)
    rng = np.random.default_rng(g * 1000 + t)
    e = cfg.num_experts
    p = {"w_gate": rng.normal(size=(e, d, f)) * 0.2,
         "w_up": rng.normal(size=(e, d, f)) * 0.2,
         "w_down": rng.normal(size=(e, f, d)) * 0.2}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(g, t, d)).astype(np.float32)
    logits = rng.normal(size=(g, t, e)).astype(np.float32) * 2
    logits[:, ::4] = np.round(logits[:, ::4])
    return cfg, p, x, logits


@pytest.mark.parametrize("arch,g,t,cf,dtype", ROUTE_CASES)
def test_routing_forms_equal_the_old_forms_and_repro(arch, g, t, cf, dtype):
    """``expert_slots`` gives the old forms' order, keep and slot (dtype,
    shape, every integer) and ``_dispatch_combine`` their output bit for
    bit; in float32 each group's output is repro's ``_dispatch_combine``
    on the same choices within 1e-5 of its largest |value|, and the kept
    pairs in sorted order are repro's."""
    cfg, p, x, logits = _route_inputs(arch, g, t, cf, dtype)
    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x).to(tdt)
    w, idx = TM._route(torch.from_numpy(logits), cfg.experts_per_token)
    cap = TM._capacity(cfg, t)
    got = TM.expert_slots(idx, cfg.num_experts, cap)
    want = _old_expert_slots(idx, cfg.num_experts, cap)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    dropped = int((~got[1]).sum())
    if cf < 1 or arch == "kimi-k2-1t-a32b":
        assert dropped > 0
    y = TM._dispatch_combine(cfg, tp, tx, w, idx, cap)
    y_old = _old_dispatch_combine(cfg, tp, tx, w, idx, cap)
    assert y.dtype == y_old.dtype == tdt and y.shape == (g, t, cfg.d_model)
    assert torch.equal(_bits(y), _bits(y_old))
    if dtype != "float32":
        return
    jcfg = j_get_config(arch).replace(d_model=cfg.d_model, d_ff=cfg.d_ff,
                                      capacity_factor=cf)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for gi in range(g):
        jy = JM._dispatch_combine(jcfg, jp, jnp.asarray(x[gi]),
                                  jnp.asarray(w[gi].numpy()),
                                  jnp.asarray(idx[gi].numpy()), cap)
        jy = np.asarray(jy)
        scale = max(1.0, float(np.abs(jy).max()))
        assert float(np.abs(y[gi].numpy() - jy).max()) <= 1e-5 * scale
        flat = jnp.asarray(idx[gi].numpy()).reshape(-1)
        order = np.asarray(jnp.argsort(flat))
        se = np.asarray(flat)[order]
        start = np.searchsorted(se, np.arange(cfg.num_experts))
        keep = (np.arange(se.size) - start[se]) < cap
        np.testing.assert_array_equal(got[0][gi].numpy(), order)
        np.testing.assert_array_equal(got[1][gi].numpy(), keep)


def test_moe_ffn_global_and_per_row_match_repro():
    """``moe_ffn`` on both layouts (4 x 24 tokens as one group, 2 x 2,056
    as rows) at a capacity where pairs drop: output and balance loss
    within 1e-5 of repro's (float32, the same parameters)."""
    jcfg = j_smoke_config("olmoe-1b-7b").replace(capacity_factor=0.5)
    tcfg = t_smoke_config("olmoe-1b-7b").replace(capacity_factor=0.5)
    jp = japi.init_params(jcfg, jax.random.key(0))
    jmoe = jax.tree.map(lambda a: np.array(a[0]), jp["layers"]["moe"])
    tmoe = {k: torch.from_numpy(v) for k, v in jmoe.items()}
    rng = np.random.default_rng(5)
    for b, s in ((4, 24), (2, 2056)):
        x = rng.normal(size=(b, s, tcfg.d_model)).astype(np.float32)
        ty, taux = TM.moe_ffn(tcfg, tmoe, torch.from_numpy(x))
        jy, jaux = JM.moe_ffn(jcfg, jax.tree.map(jnp.asarray, jmoe),
                              jnp.asarray(x))
        scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
        assert float(np.abs(ty.numpy() - np.asarray(jy)).max()) \
            <= 1e-5 * scale
        assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


# ---------------------------------------------------------------------------
# (ii) the train state's placements on the production meshes
# ---------------------------------------------------------------------------

def _t_mesh(multi_pod):
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = production_layout(multi_pod)
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single", "multi"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_shardings_match_repro_router_included(arch, multi_pod):
    """Published olmoe, kimi and jamba train on the production layout,
    and ``train_shardings`` of the whole state (plain and factored bf16
    second moment) is repro's spec of every leaf, the router's
    ("embed", "experts") included, on 16 x 16 and 2 x 16 x 16."""
    cfg, jcfg = t_get_config(arch), j_get_config(arch)
    assert not cfg.moe_ep
    tm = _t_mesh(multi_pod)
    shape, names = production_layout(multi_pod)
    jm = types.SimpleNamespace(shape=dict(zip(names, shape)))
    for opt_kw in ({}, {"factored_v": True, "state_dtype": "bfloat16"}):
        sh = TS.train_shardings(cfg, TO.OptConfig(**opt_kw), tm)
        jo = JO.OptConfig(**opt_kw)
        with JSH.sharding_ctx(jm):
            axes = jax.tree.leaves(JS.train_state_axes(jcfg, jo),
                                   is_leaf=lambda x: isinstance(x, tuple))
            want = [JSH.spec_for(x.shape, a) for x, a in zip(
                jax.tree.leaves(JS.train_state_shapes(jcfg, jo)), axes)]
        got = tree_flatten(sh)[0]
        assert [g.spec for g in got] == [tuple(w) for w in want]
        routers = [s.spec for s in _router_leaves(sh["params"])]
        assert routers and all(r == (None, "data", "model")
                               for r in routers), routers


def _router_leaves(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "router":
                yield v
            else:
                yield from _router_leaves(v)


# ---------------------------------------------------------------------------
# (iii) one production step of olmoe and jamba on a 2 x 2 gloo mesh
# ---------------------------------------------------------------------------

def _layout_script():
    spec = importlib.util.spec_from_file_location(
        "production_layout_2x2",
        os.path.join(ROOT, "scripts", "production_layout_2x2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PL = _layout_script()
MOE_CASES = [c[0] for c in PL.MOE_CASES]
# tests/test_torch_distributed.py's limits for the production layout
# against repro's jitted one-device step (float32, summation order)
PROD_METRIC_RTOL = {"loss": 2e-6, "aux": 2e-6, "tokens": 0.0, "lr": 1e-6,
                    "grad_norm": 2e-5}


def _jstate(cfg, opt, seed=0):
    """A repro state with non-zero moments, as numpy."""
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


def _repro_router_logits(jcfg, state, batch):
    """Every MoE layer's router logits in repro's forward, in call order
    (``_route`` taped through ``jax.debug.callback``)."""
    tape = []
    orig = JM._route

    def taped(logits, k):
        jax.debug.callback(lambda v: tape.append(np.asarray(v)), logits,
                           ordered=True)
        return orig(logits, k)
    JM._route = taped
    try:
        jax.block_until_ready(jax.jit(
            lambda p, b: japi.loss(jcfg, p, b))(
                jax.tree.map(jnp.asarray, state["params"]), batch))
        jax.effects_barrier()
    finally:
        JM._route = orig
    return tape


# repro's moe_ep step on a 2 x 2 mesh of 4 fake devices: its shard_map
# leaves each device the balance loss of its own data rank (out_specs
# P() unchecked), which the metrics average over the devices (the
# port's aux: the data ranks' mean, whose gradient is the step's)
_REPRO_EP = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {scripts!r})
import production_layout_2x2 as PL
from repro.ckpt import checkpoint as RC
from repro.configs import smoke_config
from repro.launch.mesh import compat_make_mesh
from repro.models.sharding import sharding_ctx
from repro.train import optimizer as JO, steps as JS
d, name = {d!r}, {name!r}
cfg = smoke_config({arch!r}).replace(**PL.CASE_CFG[name])
jo = JO.OptConfig(**PL.OPT_KW)
shapes = jax.tree.map(np.asarray, JS.init_train_state(cfg, jo,
                                                      jax.random.key(0)))
state = RC.restore(d + "/" + name + "/in", shapes, 3)
z = np.load(d + "/" + name + "/batch.npz")
with sharding_ctx(compat_make_mesh((2, 2), ("data", "model"))):
    new, m = jax.jit(JS.make_train_step(cfg, jo, 1))(
        jax.tree.map(jnp.asarray, state), {{k: z[k] for k in z.files}})
RC.save(d + "/" + name + "/repro_out", 4, jax.tree.map(np.asarray, new))
print(json.dumps({{k: float(np.mean([np.asarray(s.data)
                                     for s in v.addressable_shards]))
                   for k, v in m.items()}}))
"""


def _repro_ep_step(d, name, arch):
    """repro's moe_ep step of case ``name`` on 2 x 2 fake devices, in its
    own interpreter: (new state, metrics averaged over the devices)."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    return subprocess.Popen(
        [sys.executable, "-c", _REPRO_EP.format(
            scripts=os.path.join(ROOT, "scripts"), d=str(d), name=name,
            arch=arch)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """scripts/production_layout_2x2.py --cases olmoe,jamba,olmoe_ep over
    4 gloo ranks from repro's states (non-zero moments, step 3), and
    meanwhile repro's jitted one-device step and its router logits on
    each, or for a ``moe_ep`` case repro's step on 2 x 2 devices.
    Returns the directory, the script's report and repro's
    {case: (state, metrics, router logits)}."""
    d = tmp_path_factory.mktemp("moe_production")
    inputs = {}
    for name, arch, micro, kw in PL.MOE_CASES:
        jcfg = j_smoke_config(arch).replace(**PL.CASE_CFG.get(name, {}))
        jo = JO.OptConfig(**PL.OPT_KW, **kw)
        batch = PL.case_batch(PL.case_config(name),
                              seq=PL.CASE_SEQ.get(name, 32))
        inputs[name] = (jcfg, jo, micro, _jstate(jcfg, jo), batch)
        RC.save(str(d / name / "in"), 3, inputs[name][3])
        np.savez(d / name / "batch.npz", **batch)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "production_layout_2x2.py"),
         "--out", str(d), "--cases", ",".join(MOE_CASES)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC})
    want = {}
    ep = {name: _repro_ep_step(d, name, arch)
          for name, arch, _, _ in PL.MOE_CASES if inputs[name][0].moe_ep}
    try:
        for name, (jcfg, jo, micro, jstate, batch) in inputs.items():
            if jcfg.moe_ep:
                out, err = ep[name].communicate(timeout=600)
                assert ep[name].returncode == 0, err[-4000:]
                jm = json.loads(out.strip().splitlines()[-1])
                want[name] = (RC.restore(str(d / name / "repro_out"),
                                         jstate, 4), jm, None)
                continue
            logits = _repro_router_logits(jcfg, jstate, batch)
            new, metrics = jax.jit(JS.make_train_step(jcfg, jo, micro))(
                jax.tree.map(jnp.asarray, jstate), batch)
            want[name] = (new, metrics, logits)
    finally:
        for p in ep.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            pytest.fail("scripts/production_layout_2x2.py ran past 600 s")
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert lines, err[-4000:]
    return d, json.loads(lines[-1]), want


# olmoe_ep against repro's 2 x 2 moe_ep step: the grad norm's float32
# spread between the packages on its batch is 2.0e-5 for the one-process
# steps (moe_ffn, torch 2.13.0+cpu against jax 0.9.0) and 2.4e-5 here;
# every gradient leaf agrees within 2.8e-5 of its largest |value| with
# the balance loss's weight at 0.01 and at 0 alike
CASE_METRIC_RTOL = {"olmoe_ep": {"grad_norm": 5e-5}}


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_production_step_matches_one_device_repro(moe_runs, name):
    """olmoe (4 rows of 1,040 tokens: per-row routing) and jamba (4 x 32:
    one group; every period checkpointed, its published remat) at smoke
    widths and the config's capacity factor, one
    production step over 2 x 2 gloo ranks, against repro's jitted step
    on one device.  First the routing is shown to be repro's: in every
    MoE layer each token's gap between its k-th and (k+1)-th logit in
    repro exceeds twice its logits' largest difference between the
    production step and repro; some pairs drop.  Then the metrics
    (PROD_METRIC_RTOL) and every new leaf within 2e-5 + 2e-5 |x|.
    olmoe_ep (moe_ep, 4 x 32 at capacity 8.0) is held to repro's own
    moe_ep step on 2 x 2 devices instead, whose shard_map routes each
    data rank's rows: the metrics (CASE_METRIC_RTOL) and every leaf."""
    d, report, want = moe_runs
    jnew, jm, jlogits = want[name]
    if jlogits is None:
        assert report["cases"][name]["all_to_all"] > 0
        metrics = np.load(d / name / "metrics.npz")
        rtol = {**PROD_METRIC_RTOL, **CASE_METRIC_RTOL.get(name, {})}
        for key, r in rtol.items():
            np.testing.assert_allclose(metrics[key], jm[key], rtol=r,
                                       atol=1e-7, err_msg=key)
        back = RC.restore(str(d / name / "out"), jnew, 4)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnew)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-5, atol=2e-5)
        return
    k = t_smoke_config(dict((c[0], c[1]) for c in PL.MOE_CASES)[name]
                       ).experts_per_token
    z = np.load(d / name / "router.npz")
    got = [z[f"arr_{i}"] for i in range(len(z.files))]
    # the forward's MoE calls come first; a checkpointed layer's
    # recompute in the backward (jamba's remat "full") calls again
    assert len(jlogits) > 0 and len(got) % len(jlogits) == 0
    got = got[:len(jlogits)]
    for a, b in zip(got, jlogits):
        assert a.shape == b.shape
        # each logit of a token moves by at most its drift, so its top k
        # stay repro's while the k-th leads the (k+1)-th by twice that
        drift = np.abs(a - b).max(axis=-1)
        top = -np.sort(-b, axis=-1)
        gap = top[..., k - 1] - top[..., k]
        assert (gap > 2 * drift).all(), (gap.min(), drift.max())
    assert report["cases"][name]["dropped"] > 0
    assert report["cases"][name]["routing_equal"]
    metrics = np.load(d / name / "metrics.npz")
    for key, rtol in PROD_METRIC_RTOL.items():
        np.testing.assert_allclose(metrics[key], np.asarray(jm[key]),
                                   rtol=rtol, atol=1e-7, err_msg=key)
    back = RC.restore(str(d / name / "out"), jnew, 4)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)
    # the script's limit on m (its CASE_TOL, against one process) holds
    # against repro's step as well
    got_m = [np.asarray(x) for x in jax.tree.leaves(back["opt"]["m"])]
    want_m = [np.asarray(x) for x in jax.tree.leaves(jnew["opt"]["m"])]
    scale = max(float(np.abs(x).max()) for x in want_m)
    assert max(float(np.abs(a - b).max()) for a, b in zip(got_m, want_m)) \
        <= PL.tol(name)["m"] * scale


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_production_step_shards_and_matches_the_dry_run(moe_runs, name):
    """Every rank shards leaves over "data" and over "model" (the experts
    among them), holds the dry run's local state bytes, routes as the
    one-process step does, and is within the script's limits of it."""
    _, report, _ = moe_runs
    r = report["cases"][name]
    assert len(r["sharded_data_model_by_rank"]) == PL.WORLD
    for data, model in r["sharded_data_model_by_rank"]:
        assert data > 0 and model > 0
    assert r["local_bytes_by_rank"] == r["dryrun_bytes_by_rank"]
    for key, tol in PL.tol(name).items():
        assert r["err"][key] <= tol, (key, r["err"])
    assert r["within_tol"] and (r["all_to_all"] > 0
                                if PL.CASE_CFG.get(name, {}).get("moe_ep")
                                else r["routing_equal"])


def test_moe_production_script_reports_ok(moe_runs):
    _, report, _ = moe_runs
    assert report["ok"] and report["exit_codes"] == [0] * PL.WORLD
    assert sorted(report["cases"]) == sorted(MOE_CASES)


# ---------------------------------------------------------------------------
# (iv) a dry-run cell of olmoe end to end
# ---------------------------------------------------------------------------

def test_dryrun_olmoe_decode_cell_end_to_end(tmp_path):
    """``python -m repro_torch.launch.dryrun`` for olmoe-1b-7b x
    decode_32k x single: ok in under 240 s, the expert products on this
    rank's 64 / 16 = 4 experts (``top_flops``), and ``useful_ratio`` in
    tests/test_torch_launch.py's band for decode cells."""
    arch = "olmoe-1b-7b"
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--arch", arch, "--shape", "decode_32k", "--mesh",
         "single", "--out", str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": SRC}, capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert time.monotonic() - t0 < 240
    r = json.loads((tmp_path / f"{arch}__decode_32k__single.json")
                   .read_text())
    assert r["status"] == "ok" and r["chips"] == 256
    assert r["f64_leaks"] == [] and r["hbm_fit"]
    assert r["roofline"]["flops_per_dev"] > 0
    assert 1 / (16 * 1.1) <= r["useful_ratio"] <= 1.1
    experts = t_get_config(arch).num_experts
    bmms = [op for op, _ in r["top_flops"] if op.startswith("bmm (")]
    local = [op for op in bmms if op.startswith(f"bmm ({experts // 16}, ")]
    assert local, r["top_flops"]
    assert not any(op.startswith(f"bmm ({experts}, ") for op in bmms)


def _sbs():
    spec = importlib.util.spec_from_file_location(
        "dryrun_side_by_side",
        os.path.join(ROOT, "scripts", "dryrun_side_by_side.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_olmoe_moe_ep_train_cell_against_repro(tmp_path):
    """olmoe-1b-7b x train_4k x single with ``moe_ep`` traces in both
    packages (scripts/dryrun_side_by_side.py --cfg '{"moe_ep": true}'):
    the port runs the trainer's step on the production layout, so its
    argument bytes are repro's; its FLOPs a device are at most 1.05x
    repro's (the same shard_map body on each rank's rows); and the EP
    hops are priced, all-to-alls with wire bytes."""
    sbs = _sbs()
    kw = dict(arch="olmoe-1b-7b", shape="train_4k", multi=False,
              tmp=str(tmp_path), cfg={"moe_ep": True})
    repro = sbs.counts(sbs._run(sbs._REPRO.format(**kw)))
    port = sbs.counts(sbs._run(sbs._PORT.format(**kw)))
    assert repro["status"] == port["status"] == "ok", (repro, port)
    assert port["arg_bytes_per_dev"] == repro["arg_bytes_per_dev"] \
        == 419_276_292
    assert port["flops_per_dev"] <= 1.05 * repro["flops_per_dev"], (
        port["flops_per_dev"], repro["flops_per_dev"])
    assert port["collectives"].get("all-to-all", 0) > 0
    a2a = [w for key, w, _ in port["top_wire"]
           if key.startswith("all-to-all model")]
    assert a2a and a2a[0] > 0, port["top_wire"]

