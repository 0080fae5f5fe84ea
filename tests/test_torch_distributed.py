"""The port's distributed modules on the CPU under gloo, against
``repro``'s: the logical-axis rules (``spec_for``, fallbacks,
``tree_shardings``), the elastic save -> remesh -> restore round trip,
the int8 compressed gradient mean, expert-parallel MoE over a 2 x 2 mesh,
a data-parallel train step with unequal masks, an expert-parallel train
step, and ``launch/train.py --model-parallel 2`` over two processes.

Each rank is its own interpreter (``_start_ranks``), joined by a gloo
group over a file store in the test's ``tmp_path`` (no port, so tests on
other xdist workers cannot collide).  A rank that fails ends the whole
group at once and fails the test with its stderr; a group that outlives
its timeout is killed and fails it.  ``repro``'s side runs in a
subprocess with ``--xla_force_host_platform_device_count``, as
``tests/test_moe_ep.py`` does, and hands its inputs and results over as
``.npz`` files."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RC
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models import api as japi
from repro.models import sharding as JSH
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.models import api as tapi
from repro_torch.models import sharding as TSH
from repro_torch.models.params import tree_flatten
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# the rank programs' common head: argv is (rank, world, store, out dir)
_HEAD = """\
import os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD, STORE, OUT = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + STORE, rank=RANK,
                        world_size=WORLD)
"""


def _start_ranks(tmp_path, world: int, body: str, name: str = "ranks"):
    """Start ``body`` as ``world`` gloo ranks (output dir ``tmp_path``)."""
    script = tmp_path / f"{name}.py"
    script.write_text(_HEAD.format(src=SRC) + textwrap.dedent(body)
                      + "\ndist.destroy_process_group()\n")
    store = tmp_path / f"{name}.store"
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(store),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT) for r in range(world)]


def _wait_all(procs, timeout):
    """Wait for every process and return their stdouts; the first failure
    (or the timeout) kills the rest and fails the test."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                for p in procs:
                    p.kill()
                err = procs[bad[0]].communicate()[1]
                pytest.fail(f"process {bad[0]} exited {codes[bad[0]]}:\n"
                            f"{err[-4000:]}")
            if all(c == 0 for c in codes):
                return [p.communicate()[0] for p in procs]
            if time.monotonic() > deadline:
                pytest.fail(f"processes still running after {timeout} s "
                            f"(exit codes {codes})")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


def _start_repro(code: str, devices: int):
    """Start ``code`` in a JAX process with ``devices`` fake CPU devices."""
    env = {**os.environ, "PYTHONPATH": SRC,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


# ---------------------------------------------------------------------------
# logical-axis rules (no process group: a mesh's names and sizes suffice)
# ---------------------------------------------------------------------------

def _t_mesh(shape):
    """A DeviceMesh of ``shape`` over ("data", "model") without process
    groups (spec_for reads only its names and sizes)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=("data", "model"), _init_backend=False,
                      _rank=0)


def _j_mesh(shape):
    """repro's spec_for reads only ``mesh.shape`` ({name: size})."""
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)))


SPEC_CASES = [
    ((16, 64), ("batch", "ffn")),           # divisible: sharded
    ((8, 42), ("batch", "heads")),          # 42 heads on 4: fallback
    ((64, 64), ("ffn", "vocab")),           # "model" used once only
    ((6, 8), ("batch", "embed")),           # "data" twice: second dropped
    ((3, 8), ("batch",)),                   # 3 rows on 2: fallback
    ((4, 16, 8), ("layers", "experts")),    # trailing dims replicate
    ((8, 4, 4), ("batch", "kv_seq", "kv_heads")),
    ((2, 7), (None, "inner")),
]


@pytest.mark.parametrize("rules", [None, JSH.LONG_CONTEXT_OVERRIDES],
                         ids=["default", "long_context"])
def test_spec_for_and_fallbacks_match_repro_on_2x4(rules):
    tm, jm = _t_mesh((2, 4)), _j_mesh((2, 4))
    assert TSH.DEFAULT_RULES == JSH.DEFAULT_RULES
    assert TSH.LONG_CONTEXT_OVERRIDES == JSH.LONG_CONTEXT_OVERRIDES
    with TSH.sharding_ctx(tm, rules), JSH.sharding_ctx(jm, rules):
        for shape, logical in SPEC_CASES:
            got = TSH.spec_for(shape, logical)
            want = JSH.spec_for(shape, logical)
            assert got == tuple(want), (shape, logical, got, want)
        assert TSH.recorded_fallbacks() == JSH.recorded_fallbacks()
        assert TSH.recorded_fallbacks()           # some were recorded
    assert TSH.spec_for((8, 16), ("batch", "embed"), mesh=None) == ()
    assert TSH.recorded_fallbacks() == []         # the context restored


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "olmoe-1b-7b",
                                  "jamba-1.5-large-398b", "whisper-medium"])
@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (8, 1)])
def test_param_tree_shardings_match_repro_at_full_width(arch, shape):
    """Every parameter of a published config on the mesh: the same spec
    leaf for leaf (qwen1.5's 40 heads fall back on 4 and 8), the same
    fallbacks, and DTensor placements that follow the spec.  The whole
    train state under the trainer's ``train_shardings`` (plain and
    factored second moment), every arch on the production layout:
    repro's spec of every leaf, the moments' and the MoE router's
    included, with the live placements (a shard over a size-1 mesh
    dimension is a replica)."""
    from torch.distributed.tensor import Replicate, Shard
    tm, jm = _t_mesh(shape), _j_mesh(shape)
    with TSH.sharding_ctx(tm), JSH.sharding_ctx(jm):
        got = TSH.tree_shardings(tapi.param_shapes(t_get_config(arch)),
                                 tapi.param_axes(t_get_config(arch)))
        # repro's tree_shardings is spec_for per leaf into NamedShardings
        # (which need a real Mesh): its specs, leaf by leaf
        axes = jax.tree.leaves(japi.param_axes(j_get_config(arch)),
                               is_leaf=lambda x: isinstance(x, tuple))
        want = [JSH.spec_for(x.shape, a) for x, a in zip(
            jax.tree.leaves(japi.param_shapes(j_get_config(arch))), axes)]
        t_fall, j_fall = TSH.recorded_fallbacks(), JSH.recorded_fallbacks()
    got_l = tree_flatten(got)[0]
    assert [g.spec for g in got_l] == [tuple(w) for w in want]
    assert t_fall == j_fall
    for g in got_l:
        for d, name in enumerate(("data", "model")):
            dims = [i for i, a in enumerate(g.spec)
                    if a == name or isinstance(a, tuple) and name in a]
            assert g.placements[d] == (Shard(dims[0]) if dims
                                       else Replicate())
    cfg = t_get_config(arch)
    for opt_kw in ({}, {"factored_v": True, "state_dtype": "bfloat16"}):
        sh = TS.train_shardings(cfg, TO.OptConfig(**opt_kw), tm)
        state = tree_flatten(sh)[0]
        jo = JO.OptConfig(**opt_kw)
        jcfg = j_get_config(arch)
        with JSH.sharding_ctx(jm):
            axes = jax.tree.leaves(JS.train_state_axes(jcfg, jo),
                                   is_leaf=lambda x: isinstance(x, tuple))
            want = [JSH.spec_for(x.shape, a) for x, a in zip(
                jax.tree.leaves(JS.train_state_shapes(jcfg, jo)), axes)]
        assert [g.spec for g in state] == [tuple(w) for w in want]
        for g in state:
            for d, name in enumerate(("data", "model")):
                dims = [i for i, a in enumerate(g.spec)
                        if a == name or isinstance(a, tuple) and name in a]
                assert g.placements[d] == (
                    Shard(dims[0]) if dims and shape[d] > 1
                    else Replicate())


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (8, 1)])
def test_moe_ep_train_shardings_match_repro(shape):
    """olmoe with ``moe_ep`` trains on the production layout: its
    ``train_shardings`` (plain and factored second moment) are repro's
    specs of every leaf, the router's ("embed", "experts") and the
    experts' included, on the meshes of
    test_param_tree_shardings_match_repro_at_full_width (repro keeps a
    moe_ep config's leaves on DEFAULT_RULES; only its MoE FFN runs under
    shard_map)."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = t_get_config("olmoe-1b-7b").replace(moe_ep=True)
    jcfg = j_get_config("olmoe-1b-7b").replace(moe_ep=True)
    tm, jm = _t_mesh(shape), _j_mesh(shape)
    for opt_kw in ({}, {"factored_v": True, "state_dtype": "bfloat16"}):
        state = tree_flatten(TS.train_shardings(cfg, TO.OptConfig(**opt_kw),
                                                tm))[0]
        jo = JO.OptConfig(**opt_kw)
        with JSH.sharding_ctx(jm):
            axes = jax.tree.leaves(JS.train_state_axes(jcfg, jo),
                                   is_leaf=lambda x: isinstance(x, tuple))
            want = [JSH.spec_for(x.shape, a) for x, a in zip(
                jax.tree.leaves(JS.train_state_shapes(jcfg, jo)), axes)]
        assert [g.spec for g in state] == [tuple(w) for w in want]
        assert any(g.spec and g.spec[0] == "model" for g in state)
        for g in state:
            for d, name in enumerate(("data", "model")):
                dims = [i for i, a in enumerate(g.spec)
                        if a == name or isinstance(a, tuple) and name in a]
                assert g.placements[d] == (
                    Shard(dims[0]) if dims and shape[d] > 1
                    else Replicate())


def test_shard_is_the_identity_on_plain_tensors():
    x = torch.arange(8.0).reshape(2, 4)
    assert TSH.shard(x, "batch", "embed") is x
    with TSH.sharding_ctx(_t_mesh((2, 4))):
        assert TSH.shard(x, "batch", "embed") is x


# ---------------------------------------------------------------------------
# repro's references over 4 fake devices, and the port over 4 gloo ranks
# ---------------------------------------------------------------------------

# psum_compressed's inputs: per rank a (1000,) and a (17, 5) gradient
# and a non-zero error buffer
PSUM_SHAPES = {"a": (1000,), "b": (17, 5)}
MOE_KW = dict(num_experts=8, experts_per_token=2, capacity_factor=8.0,
              dtype="float32", param_dtype="float32")


def _psum_inputs():
    rng = np.random.default_rng(0)
    g = {k: rng.normal(size=(4,) + s).astype(np.float32)
         for k, s in PSUM_SHAPES.items()}
    e = {k: (rng.normal(size=(4,) + s) * 1e-3).astype(np.float32)
         for k, s in PSUM_SHAPES.items()}
    return g, e


REPRO_REFS = """
import numpy as np, jax, jax.numpy as jnp
import repro
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import smoke_config
from repro.launch.mesh import compat_make_mesh
from repro.models import moe as M
from repro.models import moe_ep as MEP
from repro.models.sharding import sharding_ctx
from repro.train import compression as C
d = {d!r}
z = np.load(d + "/psum_in.npz")
mesh = Mesh(np.array(jax.devices()).reshape(4), ("data",))

def f(ga, gb, ea, eb):
    red, err = C.psum_compressed({{"a": ga[0], "b": gb[0]}},
                                 {{"a": ea[0], "b": eb[0]}}, "data")
    return red["a"][None], red["b"][None], err["a"][None], err["b"][None]
spec = P("data")
out = jax.jit(shard_map(f, mesh=mesh, in_specs=(spec,) * 4,
                        out_specs=(spec,) * 4))(
    *[jnp.asarray(z[k]) for k in ("g_a", "g_b", "e_a", "e_b")])
np.savez(d + "/psum_out.npz", mean_a=out[0], mean_b=out[1], err_a=out[2],
         err_b=out[3])

m = np.load(d + "/moe_in.npz")
cfg = smoke_config("olmoe-1b-7b").replace(**{moe_kw!r})
p = {{k[2:]: jnp.asarray(m[k]) for k in m.files if k.startswith("p_")}}
x, c = jnp.asarray(m["x"]), jnp.asarray(m["c"])
with sharding_ctx(compat_make_mesh((2, 2), ("data", "model"))):
    y, aux = jax.jit(lambda p, x: MEP.moe_ffn_ep(cfg, p, x))(p, x)
gp, gx = jax.grad(lambda p, x: jnp.sum(M.moe_ffn(cfg, p, x)[0] * c),
                  argnums=(0, 1))(p, x)
np.savez(d + "/moe.npz", y=y, aux=aux, y_ref=M.moe_ffn(cfg, p, x)[0],
         gx=gx, **{{"g_" + k: v for k, v in gp.items()}})
"""


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """One run of 4 gloo ranks (the elastic, psum and moe_ep checks of
    the port) beside one repro process over 4 fake devices (its
    psum_compressed over the 4, its moe_ffn_ep over a 2 x 2 (data,
    model) mesh, and the single-device gradient of sum(y * c)), from
    the same inputs: psum's, and repro's seeded MoE parameters, rows x
    and cotangent c.  Returns the directory and rank 0's stdout."""
    from repro.configs import smoke_config
    from repro.models import moe as JM
    from repro.models.params import init_tree
    d = tmp_path_factory.mktemp("dist")
    g, e = _psum_inputs()
    np.savez(d / "psum_in.npz", **{f"g_{k}": v for k, v in g.items()},
             **{f"e_{k}": v for k, v in e.items()})
    cfg = smoke_config("olmoe-1b-7b").replace(**MOE_KW)
    p = init_tree(JM.moe_specs(cfg), jax.random.key(0), "float32")
    x = np.asarray(jax.random.normal(jax.random.key(1), (4, 16, cfg.d_model),
                                     jax.numpy.float32)) * 0.3
    c = np.asarray(jax.random.normal(jax.random.key(2), x.shape,
                                     jax.numpy.float32))
    np.savez(d / "moe_in.npz", x=x, c=c,
             **{"p_" + k: np.asarray(v) for k, v in p.items()})
    procs = [_start_repro(REPRO_REFS.format(d=str(d), moe_kw=MOE_KW), 4)]
    procs += _start_ranks(d, 4, RANKS4.format(moe_kw=MOE_KW,
                                              step_kw=STEP_KW))
    return d, _wait_all(procs, 300)[1]


RANKS4 = """
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.ckpt import restore, save
from repro_torch.configs import smoke_config
from repro_torch.models import moe_ep as MEP
from repro_torch.models.sharding import sharding_ctx, spec_for
from repro_torch.runtime.elastic import build_mesh, remesh_shardings
from repro_torch.train import compression as C
REF = OUT

# (1) elastic: a state saved from DTensors on a (2, 2) mesh, restored
# onto (4, 1), (2, 2) and (1, 4)
state = {{"w": torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32),
          "b": torch.ones(32), "e": torch.arange(4 * 6 * 10,
                                                dtype=torch.float32
                                                ).reshape(4, 6, 10),
          "step": torch.tensor(7, dtype=torch.int32)}}
axes = {{"w": ("embed", "ffn"), "b": ("ffn",),
         "e": ("experts", "embed", "ffn"), "step": ()}}
mesh = build_mesh(model_parallel=2, device="cpu")
sh = remesh_shardings(state, axes, mesh)
save(OUT + "/ckpt", 7, {{k: distribute_tensor(v, sh[k].mesh,
                                             sh[k].placements,
                                             src_data_rank=None)
                         for k, v in state.items()}})

def expect(full, spec, mesh):
    # this rank's block of ``full`` under ``spec``, computed by hand
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    idx = []
    for d, axis in enumerate(spec):
        names = () if axis is None else (axis,) if isinstance(axis, str) \\
            else axis
        n, i = 1, 0
        for a in names:
            n, i = n * size[a], i * size[a] + coord[a]
        blk = full.shape[d] // n
        idx.append(slice(i * blk, (i + 1) * blk))
    return full[tuple(idx)]

for mp in (1, 2, WORLD):
    mesh = build_mesh(model_parallel=mp, device="cpu")
    sh = remesh_shardings(state, axes, mesh)
    back = restore(OUT + "/ckpt", state, shardings=sh)
    for k, full in state.items():
        x = back[k]
        assert isinstance(x, DTensor), k
        assert tuple(x.placements) == sh[k].placements, (k, x.placements)
        want = expect(full, sh[k].spec, mesh)
        assert torch.equal(x.to_local(), want), (mp, k)
        assert torch.equal(x.full_tensor(), full), (mp, k)
    print("remesh", mp, {{k: sh[k].spec for k in state}}, flush=True)

# (2) psum_compressed over the 4 ranks
z = np.load(REF + "/psum_in.npz")
g = {{k: torch.from_numpy(z["g_" + k][RANK]) for k in ("a", "b")}}
e = {{k: torch.from_numpy(z["e_" + k][RANK]) for k in ("a", "b")}}
mean, err = C.psum_compressed(g, e)
np.savez(OUT + f"/psum_{{RANK}}.npz", **{{"mean_" + k: v.numpy()
                                        for k, v in mean.items()}},
         **{{"err_" + k: v.numpy() for k, v in err.items()}})

# (3) moe_ffn_ep over a (2, 2) mesh: this rank's rows; the gradient of
# sum(y * c): each rank back-propagates its share over the model axis,
# every leaf's gradient is summed over the ranks that hold it
m = np.load(REF + "/moe_in.npz")
cfg = smoke_config("olmoe-1b-7b").replace(**{moe_kw!r})
mesh = build_mesh(model_parallel=2, device="cpu")
d = mesh.get_local_rank("data")
rows = slice(2 * d, 2 * d + 2)
# this rank's 4 of the 8 experts, the router whole
e = mesh.get_local_rank("model")
p = {{k: torch.from_numpy(m["p_" + k][4 * e:4 * e + 4] if k != "router"
                          else m["p_" + k]).requires_grad_()
      for k in ("router", "w_gate", "w_up", "w_down")}}
x = torch.from_numpy(m["x"][rows]).requires_grad_()
with sharding_ctx(mesh):
    y, aux = MEP.moe_ffn_ep(cfg, p, x)
share = torch.sum(y * torch.from_numpy(m["c"][rows])) / 2
grads = torch.autograd.grad(share, [x] + [p[k] for k in sorted(p)])
gx = grads[0].contiguous()
dist.all_reduce(gx, group=mesh.get_group("model"))
gp = {{}}
for k, gk in zip(sorted(p), grads[1:]):
    gk = gk.contiguous()
    # the router is on every rank, an expert slice on the data ranks
    dist.all_reduce(gk, group=None if k == "router"
                    else mesh.get_group("data"))
    gp[k] = gk.numpy()
np.savez(OUT + f"/moe_{{RANK}}.npz", y=y.detach().numpy(),
         aux=aux.detach().numpy(), gx=gx.numpy(),
         **{{"g_" + k: v for k, v in gp.items()}})

# (3b) moe_ffn_ep on the production layout's DTensors over the (2, 2)
# mesh: the leaves placed as train_shardings places them, x's rows over
# "data"; the gradients of sum(y * c) come back on the leaves, whole
from torch.distributed.tensor import Replicate, Shard
from repro_torch.models.sharding import live_placements, placements
placed = {{}}
for k in ("router", "w_gate", "w_up", "w_down"):
    logical = ("embed", "experts") if k == "router" else \
        ("experts", "embed", "ffn") if k != "w_down" else \
        ("experts", "ffn", "embed")
    full = torch.from_numpy(m["p_" + k])
    with sharding_ctx(mesh):
        pl = live_placements(placements(spec_for(full.shape, logical),
                                        mesh), mesh)
    placed[k] = distribute_tensor(full, mesh, pl,
                                  src_data_rank=None).requires_grad_()
rows_pl = (Shard(0), Replicate())
xd = DTensor.from_local(torch.from_numpy(m["x"][rows]), mesh, rows_pl,
                        run_check=False).requires_grad_()
cd = DTensor.from_local(torch.from_numpy(m["c"][rows]), mesh, rows_pl,
                        run_check=False)
with sharding_ctx(mesh):
    yd, auxd = MEP.moe_ffn_ep(cfg, placed, xd)
(yd * cd).sum().backward()
np.savez(OUT + f"/moe_dt_{{RANK}}.npz", y=yd.full_tensor().detach().numpy(),
         aux=auxd.full_tensor().detach().numpy(),
         gx=xd.grad.full_tensor().numpy(),
         placements=np.array([str(tuple(yd.placements)),
                              str(tuple(placed["w_gate"].grad.placements))]),
         **{{"g_" + k: v.grad.full_tensor().numpy()
            for k, v in placed.items()}})

# (4) the production-layout Trainer: one step on (2, 2) with a
# checkpoint, restored onto (4, 1), (1, 4) and no mesh, one more step
# on each
import json, shutil
from repro_torch.models.params import tree_flatten
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import train_state_shapes
from repro_torch.train.trainer import Trainer, TrainerConfig
cfg = smoke_config("deepseek-coder-33b")
opt = OptConfig(**{step_kw!r})
rng = np.random.default_rng(5)
batches = []
for _ in range(2):
    tok = rng.integers(16, cfg.vocab_size, (4, 32)).astype(np.int32)
    batches.append({{"tokens": tok, "targets": np.roll(tok, -1, 1)}})
ck = OUT + "/trainer_ckpt"
tr = Trainer(cfg, opt, TrainerConfig(steps=1, ckpt_dir=ck, ckpt_every=1,
                                     log_every=1),
             device="cpu", mesh=build_mesh(model_parallel=2, device="cpu"))
from repro_torch.train.steps import init_train_state
drawn = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
init_bit_equal = all(torch.equal(x.full_tensor(), y) for x, y in zip(
    tree_flatten(tr.state)[0], tree_flatten(drawn)[0]))
tr.run(iter(batches[:1]))
saved = [x.full_tensor() for x in tree_flatten(tr.state)[0]]
shard_kinds = sorted({{type(p).__name__ for x in tree_flatten(tr.state)[0]
                      for p in x.placements}})
report = {{"trained_on": dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape)),
           "placements": shard_kinds, "init_bit_equal": init_bit_equal}}
# the single process restores (Trainer without a mesh, from its own copy
# of the checkpoint) and steps first: the reference
shutil.copytree(ck, OUT + f"/trainer_ckpt_none_{{RANK}}")
one = Trainer(cfg, opt, TrainerConfig(steps=2, log_every=1, ckpt_dir=OUT
                                      + f"/trainer_ckpt_none_{{RANK}}"),
              device="cpu")
report["none_bit_equal"] = all(
    torch.equal(a, b) for a, b in zip(tree_flatten(one.state)[0], saved))
ref = one.run(iter(batches[1:]))[-1]
ref_state = tree_flatten(one.state)[0]
for mp in (1, WORLD):
    d = OUT + f"/trainer_ckpt_{{mp}}"
    if RANK == 0:
        shutil.copytree(ck, d)
    dist.barrier()
    t2 = Trainer(cfg, opt, TrainerConfig(steps=2, ckpt_dir=d, log_every=1),
                 device="cpu",
                 mesh=build_mesh(model_parallel=mp, device="cpu"))
    flat = tree_flatten(t2.state)[0]
    bit = all(torch.equal(x.full_tensor(), y) for x, y in zip(flat, saved))
    h = t2.run(iter(batches[1:]))[-1]
    err = {{k: abs(h[k] - ref[k]) for k in ("loss", "grad_norm")}}
    err["state"] = max(float((x.full_tensor() - y).abs().max())
                       for x, y in zip(tree_flatten(t2.state)[0], ref_state))
    report[f"mesh_{{mp}}"] = {{"shape": dict(zip(t2.mesh.mesh_dim_names,
                                              t2.mesh.shape)),
                              "bit_equal": bit, "err": err,
                              "step": int(t2.state["step"])}}
if RANK == 0:
    print("trainer " + json.dumps(report), flush=True)
"""


def test_elastic_restore_onto_w1_w2_and_1w_meshes(dist_runs):
    """Every rank asserted (in its run) that each restored leaf is a
    DTensor on the new mesh's placements whose local slice is the one
    the spec gives it, and whole again; here the plans are read back."""
    _, out = dist_runs
    plans = [ln for ln in out.splitlines() if ln.startswith("remesh")]
    shapes = {"w": (64, 32), "b": (32,), "e": (4, 6, 10), "step": ()}
    axes = {"w": ("embed", "ffn"), "b": ("ffn",),
            "e": ("experts", "embed", "ffn"), "step": ()}
    want = []
    for mp in (1, 2, 4):
        jm = _j_mesh((4 // mp, mp))
        want.append(f"remesh {mp} " + str({
            k: tuple(JSH.spec_for(shapes[k], axes[k], jm)) for k in shapes}))
    assert plans == want
    # the embed dim of "e" (6 rows) falls back on 4 data ranks only
    assert "'e': ('model',)" in plans[0] and \
        "'e': ('model', 'data')" in plans[2]


def test_psum_compressed_matches_repro_over_4_ranks(dist_runs):
    """The mean of the 4 ranks' dequantized float32 gradients within
    1e-6 of its largest |value| (summation order); the local error
    buffers (g + e) - q·s within 2 ulp of the largest |g + e| (XLA
    fuses the jitted expression in another order: eager, the port's
    compress_tree is bit-equal to repro's, test_torch_train.py)."""
    d, _ = dist_runs
    want = np.load(d / "psum_out.npz")
    g, e = _psum_inputs()
    for r in range(4):
        got = np.load(d / f"psum_{r}.npz")
        for k in PSUM_SHAPES:
            w = want[f"mean_{k}"][r]
            np.testing.assert_allclose(got[f"mean_{k}"], w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())
            ulp = np.spacing(np.abs(g[k][r] + e[k][r]).max())
            np.testing.assert_allclose(got[f"err_{k}"], want[f"err_{k}"][r],
                                       rtol=0, atol=2 * ulp)
            # and the compressed mean is the exact mean within int8's 1 %
            exact = g[k].mean(axis=0)
            assert np.abs(got[f"mean_{k}"] - exact).max() < \
                0.02 * np.abs(g[k]).max()


def test_moe_ffn_ep_matches_repro_on_a_2x2_mesh(dist_runs):
    """y of each rank's rows against repro's moe_ffn_ep over 2 x 2
    devices at repro's tolerance (rtol 2e-4, atol 2e-5); the balance
    loss, a per-data-rank estimate averaged over the model axis, against
    the value repro returns (its data rank 0's) for data rank 0."""
    d, _ = dist_runs
    m = np.load(d / "moe.npz")
    for r in range(4):
        got = np.load(d / f"moe_{r}.npz")
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        np.testing.assert_allclose(got["y"], m["y"][rows], rtol=2e-4,
                                   atol=2e-5)
        # capacity 8.0 drops nothing: EP's y is the single-device y
        np.testing.assert_allclose(got["y"], m["y_ref"][rows], rtol=2e-4,
                                   atol=2e-5)
    for r in (0, 1):
        np.testing.assert_allclose(np.load(d / f"moe_{r}.npz")["aux"],
                                   m["aux"], rtol=1e-6)


def test_moe_ffn_ep_gradient_is_the_single_device_gradient(dist_runs):
    """Through both all_to_all hops: the gradients of sum(y * c) w.r.t.
    x, the router and every expert equal jax.grad of repro's
    single-device moe_ffn (nothing drops at capacity 8.0), within 1e-5
    of each gradient's largest |value|: the experts train under EP."""
    d, _ = dist_runs
    m = np.load(d / "moe.npz")
    for r in range(4):
        got = np.load(d / f"moe_{r}.npz")
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        e = r % 2
        pairs = [("gx", got["gx"], m["gx"][rows]),
                 ("g_router", got["g_router"], m["g_router"])] + [
            (k, got[k], m[k][4 * e:4 * e + 4])
            for k in ("g_w_gate", "g_w_up", "g_w_down")]
        for name, a, b in pairs:
            assert np.abs(b).max() > 0, name
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=name)


def test_moe_ffn_ep_on_dtensors_matches_repro_and_one_device(dist_runs):
    """moe_ffn_ep on the production layout's DTensors over 2 x 2 ranks
    (the router ("embed", "experts") and the experts ("experts", "embed",
    "ffn") placed as the trainer places them, x's rows over "data"): y
    on x's placements equals repro's moe_ffn_ep over 2 x 2 devices
    (rtol 2e-4, atol 2e-5); aux, the mean of the two data ranks'
    estimates, lies between them; and the gradients of sum(y * c) with
    respect to x, the router and every expert, whole, equal jax.grad of
    repro's single-device moe_ffn within 1e-5 of each gradient's largest
    |value| (capacity 8.0 drops nothing): each data rank's part of a
    weight's gradient is summed over "data" and counted once over
    "model"."""
    d, _ = dist_runs
    m = np.load(d / "moe.npz")
    aux_by_data = [float(np.load(d / f"moe_{r}.npz")["aux"]) for r in (0, 2)]
    for r in range(4):
        got = np.load(d / f"moe_dt_{r}.npz")
        assert str(got["placements"][0]) == "(Shard(dim=0), Replicate())"
        np.testing.assert_allclose(got["y"], m["y"], rtol=2e-4, atol=2e-5)
        assert min(aux_by_data) <= float(got["aux"]) <= max(aux_by_data)
        np.testing.assert_allclose(float(got["aux"]), np.mean(aux_by_data),
                                   rtol=1e-6)
        for k in ("gx", "g_router", "g_w_gate", "g_w_up", "g_w_down"):
            b = m[k]
            assert np.abs(b).max() > 0, k
            np.testing.assert_allclose(got[k], b, rtol=0,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=k)


# the production-layout Trainer's checkpoint onto other meshes.  float32
# at smoke widths; the meshes split the sums differently.  The state is
# compared leaf by leaf, absolute: the second step's update m / sqrt(v)
# is near lr x sign(g) (moments from one step), so a gradient entry near
# 0 moves its parameter by up to lr (5e-4 here) on a last-bit change.
# Measured: loss 0, grad_norm 4.8e-6, state 1.6e-5 on (1, 4)
TRAINER_TOL = {"loss": 1e-5, "grad_norm": 2e-5, "state": 1e-4}


def test_production_trainer_checkpoint_restores_onto_4x1_1x4_and_no_mesh(
        dist_runs):
    """A Trainer on the production layout draws its state leaf by leaf
    on (2, 2), bit for bit the one-process init, takes one step and
    checkpoints it; a Trainer on (4, 1), on (1, 4) and one without a mesh
    restores that checkpoint bit for bit, and the next step on each mesh
    equals the one without a mesh (TRAINER_TOL)."""
    _, out = dist_runs
    line = next(ln for ln in out.splitlines() if ln.startswith("trainer "))
    r = json.loads(line[len("trainer "):])
    assert r["trained_on"] == {"data": 2, "model": 2}
    assert r["placements"] == ["Replicate", "Shard"]
    assert r["init_bit_equal"] and r["none_bit_equal"]
    for mp, shape in ((1, {"data": 4, "model": 1}),
                      (4, {"data": 1, "model": 4})):
        m = r[f"mesh_{mp}"]
        assert m["shape"] == shape and m["bit_equal"] and m["step"] == 2
        for k, tol in TRAINER_TOL.items():
            assert m["err"][k] <= tol, (mp, k, m["err"])


# ---------------------------------------------------------------------------
# train steps over 2 ranks: data parallel (dense) and expert parallel (moe)
# ---------------------------------------------------------------------------

STEP_KW = dict(lr=1e-3, warmup_steps=2, total_steps=50, weight_decay=0.01)


def _unequal_batch(cfg, b=4, s=32, seed=0):
    """A batch whose two halves keep very different mask counts (rows 0-1
    keep 30 and 27 tokens, rows 2-3 keep 5 and 0)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(16, cfg.vocab_size, (b, s)).astype(np.int32)
    keep = np.array([30, 27, 5, 0])
    mask = (np.arange(s)[None] < keep[:, None]).astype(np.float32)
    return {"tokens": tok, "targets": np.roll(tok, -1, 1), "loss_mask": mask}


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


# (name, arch, model_parallel, microbatches, config changes): (2, 1) data
# parallel, also over 2 microbatches, and (1, 2) expert parallel
STEP_CASES = [
    ("data_parallel", "deepseek-coder-33b", 1, 1, {}),
    ("data_parallel_microbatches", "deepseek-coder-33b", 1, 2, {}),
    ("expert_parallel", "olmoe-1b-7b", 2, 1,
     {"moe_ep": True, "capacity_factor": 8.0}),
    # checkpointed layers: backward's recompute runs the EP layer again,
    # after the step's sharding context has been left
    ("expert_parallel_remat", "olmoe-1b-7b", 2, 1,
     {"moe_ep": True, "capacity_factor": 8.0, "remat": "full"}),
]

STEP_RANKS = """
from repro_torch.ckpt import restore, save
from repro_torch.configs import smoke_config
from repro_torch.runtime.elastic import build_mesh
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import make_train_step, train_state_shapes
opt = OptConfig(**{opt!r})
for name, arch, mp, micro, kw in {cases!r}:
    d = OUT + "/" + name
    cfg = smoke_config(arch).replace(**kw)
    mesh = build_mesh(model_parallel=mp, device="cpu")
    step = make_train_step(cfg, opt, micro, mesh=mesh)
    shapes = train_state_shapes(cfg, opt)
    state = restore(d + "/in", shapes, shardings=step.shardings)
    z = np.load(d + "/batch.npz")
    new, metrics = step(state, {{k: z[k] for k in z.files}})
    print(name, step.layout, flush=True)
    save(d + "/out", 4, new)
    if RANK == 0:
        np.savez(d + "/metrics.npz",
                 **{{k: v.numpy() for k, v in metrics.items()}})
"""


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Every STEP_CASES step over 2 gloo ranks (one run) from a repro
    state with non-zero moments, and repro's step on one device over the
    whole batch meanwhile (olmoe's with moe_ep=False: repro's
    single-device moe_ffn).  Returns the directory and repro's
    {case: (new state, metrics)}."""
    d = tmp_path_factory.mktemp("steps")
    jo = JO.OptConfig(**STEP_KW)
    inputs = {}
    for name, arch, _, micro, kw in STEP_CASES:
        jcfg = j_smoke_config(arch).replace(
            **{k: v for k, v in kw.items() if k != "moe_ep"})
        inputs[name] = (jcfg, micro, _jstate(jcfg, jo), _unequal_batch(jcfg))
        RC.save(str(d / name / "in"), 3, inputs[name][2])
        np.savez(d / name / "batch.npz", **inputs[name][3])
    procs = _start_ranks(d, 2, STEP_RANKS.format(opt=STEP_KW,
                                                 cases=STEP_CASES))
    want = {}
    try:
        for name, (jcfg, micro, jstate, batch) in inputs.items():
            want[name] = jax.jit(JS.make_train_step(jcfg, jo, micro))(
                jax.tree.map(jax.numpy.asarray, jstate), batch)
    finally:
        out = _wait_all(procs, 300)[0]
    layouts = dict(ln.split() for ln in out.splitlines()
                   if ln.split()[:1] and ln.split()[0] in want)
    return d, want, layouts


@pytest.mark.parametrize("name", [c[0] for c in STEP_CASES])
def test_two_rank_step_matches_one_device_repro(step_runs, name):
    """One step over 2 ranks against repro's step on one device over the
    whole batch: (2, 1) data parallel with the halves' mask counts 57
    and 5 (a mean of per-rank means would be far off), also over 2
    microbatches, on the production layout (deepseek's state FSDP over
    the 2 data ranks); (1, 2) with olmoe's 4 experts split 2 and 2
    (moe_ep at capacity 8.0, where no pair drops, on the same layout),
    also with every layer checkpointed.  loss, grad_norm, tokens, aux,
    lr and every new leaf within 2e-5 (float32, summation order)."""
    d, want, layouts = step_runs
    assert layouts[name] == "production"
    jnew, jm = want[name]
    got = np.load(d / name / "metrics.npz")
    for key in ("loss", "grad_norm", "tokens", "aux", "lr"):
        np.testing.assert_allclose(got[key], np.asarray(jm[key]),
                                   rtol=2e-5, atol=2e-5, err_msg=key)
    back = RC.restore(str(d / name / "out"), jnew, 4)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# the production layout on a 2 x 2 mesh: scripts/production_layout_2x2.py
# ---------------------------------------------------------------------------

def _layout_script():
    spec = importlib.util.spec_from_file_location(
        "production_layout_2x2",
        os.path.join(ROOT, "scripts", "production_layout_2x2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PL = _layout_script()
PROD_CASES = [c[0] for c in PL.CASES]
# against repro's jitted one-device step: float32, the sharded step's
# summation order on top of the port's own distance from repro (which
# tests/test_torch_train_families.py holds at rtol 2e-5 for the state and
# 1e-3 for encdec's grad_norm).  Measured here (torch 2.13.0+cpu),
# largest over the cases: loss 1.5e-7 relative, grad_norm 5.9e-6
# (internvl2; whisper 1.8e-5), every new leaf within 1.2e-6 + 1.2e-6 |x|
PROD_METRIC_RTOL = {"loss": 2e-6, "aux": 2e-6, "tokens": 0.0, "lr": 1e-6,
                    "grad_norm": 2e-5}
PROD_GRAD_NORM_RTOL = {"whisper": 1e-3}


@pytest.fixture(scope="module")
def production_runs(tmp_path_factory):
    """scripts/production_layout_2x2.py over 4 gloo ranks from repro's
    states (non-zero moments, step 3) and the unequal-mask batches, and
    repro's jitted one-device step on each meanwhile.  Returns the
    directory, the script's report and repro's {case: (state, metrics)}."""
    d = tmp_path_factory.mktemp("production")
    inputs = {}
    for name, arch, micro, kw in PL.CASES:
        jcfg = j_smoke_config(arch)
        jo = JO.OptConfig(**PL.OPT_KW, **kw)
        batch = PL.case_batch(t_smoke_config(arch))
        inputs[name] = (jcfg, jo, micro, _jstate(jcfg, jo), batch)
        RC.save(str(d / name / "in"), 3, inputs[name][3])
        np.savez(d / name / "batch.npz", **batch)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "production_layout_2x2.py"),
         "--out", str(d)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC})
    want = {}
    try:
        for name, (jcfg, jo, micro, jstate, batch) in inputs.items():
            want[name] = jax.jit(JS.make_train_step(jcfg, jo, micro))(
                jax.tree.map(jax.numpy.asarray, jstate), batch)
    finally:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            pytest.fail("scripts/production_layout_2x2.py ran past 600 s")
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert lines, err[-4000:]
    return d, json.loads(lines[-1]), want


@pytest.mark.parametrize("name", PROD_CASES)
def test_production_layout_step_matches_one_device_repro(production_runs,
                                                         name):
    """One step of the production layout over 2 x 2 gloo ranks (every
    leaf a DTensor, FSDP over "data", tensor parallel over "model")
    against repro's jitted step on one device over the whole batch
    (mask counts 30, 27, 5 and 0): the metrics (PROD_METRIC_RTOL) and
    every new leaf within 2e-5 + 2e-5 |x|."""
    d, _, want = production_runs
    jnew, jm = want[name]
    got = np.load(d / name / "metrics.npz")
    for key, rtol in PROD_METRIC_RTOL.items():
        if key == "grad_norm":
            rtol = PROD_GRAD_NORM_RTOL.get(name, rtol)
        np.testing.assert_allclose(got[key], np.asarray(jm[key]),
                                   rtol=rtol, atol=1e-7, err_msg=key)
    back = RC.restore(str(d / name / "out"), jnew, 4)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("name", PROD_CASES)
def test_production_layout_shards_both_axes_and_matches_the_dry_run(
        production_runs, name):
    """On every rank at least one leaf of the new state is sharded over
    "data" and one over "model", and the rank's local state bytes equal
    launch/dryrun.py::operand_layout's for the mesh; the step is within
    the script's limits of the one-process step."""
    _, report, _ = production_runs
    r = report["cases"][name]
    assert len(r["sharded_data_model_by_rank"]) == PL.WORLD
    for data, model in r["sharded_data_model_by_rank"]:
        assert data > 0 and model > 0
    assert r["local_bytes_by_rank"] == r["dryrun_bytes_by_rank"]
    for k, tol in PL.tol(name).items():
        assert r["err"][k] <= tol, (k, r["err"])
    assert r["within_tol"]


def test_production_layout_script_reports_ok(production_runs):
    _, report, _ = production_runs
    assert report["ok"] and report["exit_codes"] == [0] * PL.WORLD
    assert report["torch"] == torch.__version__


def test_ssd_chunk_states_equal_the_three_operand_einsum():
    """models/ssm.py's chunk states, two einsums for DTensor's sake,
    equal the three-operand "bckn,bckh,bckhp->bchpn" it replaced: bit
    for bit where opt_einsum picks the contraction order (as here),
    within float32 rounding otherwise."""
    from repro_torch.models import ssm as TSSM
    g = torch.Generator().manual_seed(0)
    bsz, nc, q, n, h, p = 2, 4, 16, 8, 6, 5
    b_c = torch.randn(bsz, nc, q, n, generator=g)
    decay = torch.rand(bsz, nc, q, h, generator=g)
    xdt = torch.randn(bsz, nc, q, h, p, generator=g)
    got = torch.einsum("bckn,bckhp->bchpn", b_c, xdt * decay[..., None])
    want = torch.einsum("bckn,bckh,bckhp->bchpn", b_c, decay, xdt)
    if torch.backends.opt_einsum.is_available():
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # and the function computes its chunk states that way: its final
    # state over one chunk is the chunk state itself
    cfg = types.SimpleNamespace(ssm_chunk=q)
    xh = torch.randn(bsz, q, h, p, generator=g)
    dt = torch.rand(bsz, q, h, generator=g)
    bb = torch.randn(bsz, q, n, generator=g)
    cc = torch.randn(bsz, q, n, generator=g)
    a_log = -torch.rand(h, generator=g)
    _, state = TSSM.ssd_chunked(cfg, xh, dt, bb, cc, a_log)
    cum = torch.cumsum((dt * a_log).reshape(bsz, 1, q, h), dim=2)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)
    xdt_c = (xh.float() * dt[..., None]).reshape(bsz, 1, q, h, p)
    old = torch.einsum("bckn,bckh,bckhp->bchpn",
                       bb.reshape(bsz, 1, q, n), to_end, xdt_c)[:, 0]
    if torch.backends.opt_einsum.is_available():
        assert torch.equal(state, old)
    else:
        torch.testing.assert_close(state, old, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv_and_embed_are_their_old_forms(dtype):
    """models/ssm.py's causal conv, its leading zeros by cat (torch
    2.11's DTensor cannot plan F.pad), equals the F.pad form bit for
    bit; layers.embed of plain tokens is the indexed read, its gradient
    included."""
    import torch.nn.functional as F

    from repro_torch.models import layers as TL
    from repro_torch.models import ssm as TSSM
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 40, 24, generator=g).to(dtype)
    k = torch.randn(4, 24, generator=g)
    pad = F.pad(x, (0, 0, 3, 0))
    old = torch.zeros_like(x)
    for i in range(4):
        old = old + pad[:, i:i + 40] * k[i].to(dtype)
    assert torch.equal(TSSM._causal_conv(x, k), old)
    table = torch.randn(64, 8, generator=g).requires_grad_()
    tok = torch.randint(0, 64, (3, 40), generator=g)
    got = TL.embed({"tok": table}, tok, dtype)
    (gw,) = torch.autograd.grad(got.float().sum(), table)
    want = table[tok.long()].to(dtype)
    (ww,) = torch.autograd.grad(want.float().sum(), table)
    assert torch.equal(got, want) and torch.equal(gw, ww)


# ---------------------------------------------------------------------------
# the launcher over 2 processes
# ---------------------------------------------------------------------------

def test_launch_train_model_parallel_two_processes(tmp_path):
    """``launch/train.py --model-parallel 2 --device cpu --smoke``: 3 steps
    of olmoe over a (1, 2) mesh on the production layout, as repro's
    launcher trains it (no forced moe_ep: experts over the model axis
    as DTensors), rank 0 feeding both; its checkpoint holds whole leaves
    that repro restores."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "olmoe-1b-7b", "--smoke", "--steps", "3", "--seq-len", "32",
           "--batch", "2", "--device", "cpu", "--model-parallel", "2",
           "--init-method", f"file://{tmp_path}/store", "--ckpt-dir",
           str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    procs = [subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": SRC, "RANK": str(r),
                        "WORLD_SIZE": "2"}) for r in range(2)]
    out = _wait_all(procs, 240)[0]
    assert "mesh={'data': 1, 'model': 2} moe_ep=False layout=production" \
        in out, out
    assert "step     3" in out, out
    assert RC.latest_step(str(tmp_path / "ckpt")) == 3
    jcfg = j_smoke_config("olmoe-1b-7b")
    shapes = JS.train_state_shapes(jcfg, JO.OptConfig())
    back = RC.restore(str(tmp_path / "ckpt"), shapes, 3)
    assert int(back["step"]) == 3
    w = back["params"]["layers"]["moe"]["w_gate"]
    assert w.shape == (2, 4, 64, 128) and np.isfinite(np.asarray(w)).all()


_LAUNCH_SEEDED = """
import sys
import numpy as np
sys.path.insert(0, {src!r})
import repro_torch.launch.train as LT


class Seeded:
    # the batches the test wrote, in place of the LM data plane
    def __iter__(self):
        for i in range({n}):
            z = np.load({d!r} + f"/batch_{{i}}.npz")
            yield {{k: z[k] for k in z.files}}

    def close(self):
        pass


LT.feed_source = lambda cfg, dev, seq, batch: Seeded()
sys.exit(LT.main(sys.argv[1:]))
"""


def test_launch_train_production_layout_two_processes(tmp_path):
    """``launch/train.py --model-parallel 2 --device cpu --smoke`` on
    deepseek over two processes: a (1, 2) mesh on the production layout
    (``layout=production``), resumed from a checkpoint repro wrote at
    step 3, two steps over batches the test wrote (in place of the data
    plane, rank 0 feeding both); each checkpoint it writes is repro's
    one-device step from the one before, within 2e-5 + 2e-5 |x|."""
    jcfg = j_smoke_config("deepseek-coder-33b")
    jo = JO.OptConfig(lr=3e-4, warmup_steps=2, total_steps=5)
    state = _jstate(jcfg, jo)
    ck = tmp_path / "ckpt"
    RC.save(str(ck), 3, state)
    batches = [_unequal_batch(jcfg, seed=s) for s in (1, 2)]
    for i, b in enumerate(batches):
        np.savez(tmp_path / f"batch_{i}.npz", **b)
    script = tmp_path / "launch.py"
    script.write_text(_LAUNCH_SEEDED.format(src=SRC, n=len(batches),
                                            d=str(tmp_path)))
    cmd = [sys.executable, str(script), "--arch", "deepseek-coder-33b",
           "--smoke", "--steps", "5", "--seq-len", "32", "--batch", "4",
           "--device", "cpu", "--model-parallel", "2", "--init-method",
           f"file://{tmp_path}/store", "--ckpt-dir", str(ck),
           "--ckpt-every", "1"]
    procs = [subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": SRC, "RANK": str(r),
                        "WORLD_SIZE": "2"}) for r in range(2)]
    out = _wait_all(procs, 240)[0]
    assert "mesh={'data': 1, 'model': 2} moe_ep=False layout=production" \
        in out, out
    assert "step     5" in out, out
    step = jax.jit(JS.make_train_step(jcfg, jo))
    cur = jax.tree.map(jax.numpy.asarray, state)
    for n, b in zip((4, 5), batches):
        cur, _ = step(cur, b)
        back = RC.restore(str(ck), cur, n)
        for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(cur)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(w),
                                       rtol=2e-5, atol=2e-5)
        cur = back          # the next step from what the port wrote
