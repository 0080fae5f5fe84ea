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
from repro_torch.models import api as tapi
from repro_torch.models import sharding as TSH
from repro_torch.models.params import tree_flatten

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
    fallbacks, and DTensor placements that follow the spec."""
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
    procs += _start_ranks(d, 4, RANKS4.format(moe_kw=MOE_KW))
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
from repro_torch.train.steps import (global_state, local_state,
                                     make_train_step, train_state_shapes)
opt = OptConfig(**{opt!r})
for name, arch, mp, micro, kw in {cases!r}:
    d = OUT + "/" + name
    cfg = smoke_config(arch).replace(**kw)
    mesh = build_mesh(model_parallel=mp, device="cpu")
    step = make_train_step(cfg, opt, micro, mesh=mesh)
    whole = restore(d + "/in", train_state_shapes(cfg, opt), device="cpu")
    state = local_state(whole, step.shardings)
    z = np.load(d + "/batch.npz")
    new, metrics = step(state, {{k: z[k] for k in z.files}})
    save(d + "/out", 4, global_state(new, step.shardings))
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
        _wait_all(procs, 300)
    return d, want


@pytest.mark.parametrize("name", [c[0] for c in STEP_CASES])
def test_two_rank_step_matches_one_device_repro(step_runs, name):
    """One step over 2 ranks against repro's step on one device over the
    whole batch: (2, 1) data parallel with the halves' mask counts 57
    and 5 (a mean of per-rank means would be far off), also over 2
    microbatches; (1, 2) with olmoe's 4 experts split 2 and 2 (moe_ep at
    capacity 8.0, where no pair drops), also with every layer
    checkpointed.  loss, grad_norm, tokens, aux,
    lr and every new leaf within 2e-5 (float32, summation order)."""
    d, want = step_runs
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
# the launcher over 2 processes
# ---------------------------------------------------------------------------

def test_launch_train_model_parallel_two_processes(tmp_path):
    """``launch/train.py --model-parallel 2 --device cpu --smoke``: 3 steps
    of olmoe over a (1, 2) mesh, experts split over the model axis, rank
    0 feeding both; its checkpoint holds whole leaves that repro
    restores."""
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
    assert "mesh={'data': 1, 'model': 2} moe_ep=True" in out, out
    assert "step     3" in out, out
    assert RC.latest_step(str(tmp_path / "ckpt")) == 3
    jcfg = j_smoke_config("olmoe-1b-7b").replace(moe_ep=True)
    shapes = JS.train_state_shapes(jcfg, JO.OptConfig())
    back = RC.restore(str(tmp_path / "ckpt"), shapes, 3)
    assert int(back["step"]) == 3
    w = back["params"]["layers"]["moe"]["w_gate"]
    assert w.shape == (2, 4, 64, 128) and np.isfinite(np.asarray(w)).all()
