"""The port's launch tooling (``repro_torch.launch.{mesh,opcost,roofline,
report,dryrun}``) against ``repro.launch``'s, on the CPU.

  * the H100 model and the production meshes over fake process groups;
  * ``opcost`` on programs with hand-computable costs (the counterparts
    of ``tests/test_hlocost.py``'s);
  * the FLOPs of each family's unsharded train step and prefill at smoke
    widths against ``repro``'s ``hlocost`` of the same jitted step;
  * per-device argument bytes and fallbacks of all 80 cells, and
    ``model_flops`` and ``report.fmt_row`` against ``repro``'s;
  * two dry-run cells end to end, each in its own interpreter (a process
    group is process-wide);
  * the program the dry run traces, run for real on a 2 x 2 gloo mesh of
    four processes, against the single-process step;
  * stand-in tensors never reach a kernel launch.
"""

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

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import hlocost as JHC
from repro.launch import report as JREP
from repro.launch import roofline as JRL
from repro.models import api as japi
from repro.models import sharding as JSH
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as TD
from repro_torch.launch import opcost as OC
from repro_torch.launch import report as TREP
from repro_torch.launch import roofline as TRL
from repro_torch.launch.mesh import H100, production_layout
from repro_torch.models.params import tree_flatten, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCHS = TD.SWEEP_ORDER
CELLS = list(TD.cells())


def _run(code: str, timeout: float = 300, cwd: str = ROOT):
    """Run ``code`` in a fresh interpreter; its stdout's last line as
    JSON."""
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# mesh.py
# ---------------------------------------------------------------------------

def test_h100_is_the_data_sheet_part():
    assert H100.name == "h100-sxm"
    assert (H100.peak_flops, H100.peak_f32_flops) == (989e12, 67e12)
    assert (H100.hbm_bw, H100.hbm_bytes) == (3.35e12, 80e9)
    assert H100.ici_bw == 450e9
    assert H100.peak_tf32_flops == 494.5e12
    assert [H100.peak_for(k) for k in ("bfloat16", "tf32", "float32")] \
        == [989e12, 494.5e12, 67e12]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
def test_production_mesh_over_a_fake_group(multi_pod):
    got = _run(f"""
        import json
        from repro_torch.launch.mesh import (fake_process_group,
                                             make_production_mesh)
        ranks = {512 if multi_pod else 256}
        with fake_process_group(ranks):
            import torch.distributed as dist
            m = make_production_mesh(multi_pod={multi_pod}, device="cpu")
            out = {{"shape": list(m.shape), "names": list(m.mesh_dim_names),
                   "world": dist.get_world_size()}}
        out["after"] = dist.is_initialized()
        print(json.dumps(out))
    """)
    shape, names = production_layout(multi_pod)
    assert got == {"shape": list(shape), "names": list(names),
                   "world": 512 if multi_pod else 256, "after": False}
    assert shape == ((2, 16, 16) if multi_pod else (16, 16))


def test_launch_modules_import_neither_jax_nor_repro():
    bad = _run("""
        import json, sys
        import repro_torch.launch.mesh, repro_torch.launch.opcost
        import repro_torch.launch.roofline, repro_torch.launch.report
        import repro_torch.launch.dryrun
        print(json.dumps([m for m in sys.modules if m.split(".")[0] in
                          ("jax", "repro")]))
    """)
    assert bad == []


# ---------------------------------------------------------------------------
# opcost.py
# ---------------------------------------------------------------------------

def test_single_matmul_flops_exact():
    a = torch.empty(128, 256, device="meta")
    b = torch.empty(256, 512, device="meta")
    _, cost = OC.count(torch.matmul, a, b)
    assert cost.flops == 2 * 128 * 256 * 512
    # traffic >= read A + read B + write C
    assert cost.hbm_bytes >= 4 * (128 * 256 + 256 * 512 + 128 * 512)
    assert cost.wire_bytes == 0 and cost.coll_counts == {}


def test_matmul_flops_are_priced_at_their_type_peak(monkeypatch):
    """The compute term divides each operand type's FLOPs by its own
    peak: bf16 and float32 apart, and float32 at TF32's while cuBLAS may
    use it."""
    def mm(dtype):
        return (torch.empty(64, 32, dtype=dtype, device="meta"),
                torch.empty(32, 16, dtype=dtype, device="meta"))

    def f(a, b, c, d):
        return a @ b, c @ d

    n = 2 * 64 * 32 * 16
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cost = OC.count(f, *mm(torch.bfloat16), *mm(torch.float32))[1]
    assert cost.flops_by_dtype == {"bfloat16": n, "float32": n}
    assert cost.flops_by_op == {
        "mm (64, 32) x (32, 16) bfloat16": n,
        "mm (64, 32) x (32, 16) float32": n}
    rf = TRL.analyze_module_cost(cost, H100)
    assert rf.compute_s == pytest.approx(n / 989e12 + n / 67e12)
    assert rf.flops_by_dtype == cost.flops_by_dtype
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cost = OC.count(f, *mm(torch.float32), *mm(torch.float32))[1]
    assert cost.flops_by_dtype == {"tf32": 2 * n}
    assert cost.top_flops(1) == [("mm (64, 32) x (32, 16) tf32", 2 * n)]
    assert TRL.analyze_module_cost(cost, H100).compute_s == \
        pytest.approx(2 * n / 494.5e12)


def test_loop_costs_scale_with_trip_count():
    """10 layers cost 10x one layer (hlocost needs trip counts for this;
    the counter sees every op the loop runs)."""
    def f(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    x = torch.empty(64, 128, device="meta")
    one = OC.count(f, x, [torch.empty(128, 128, device="meta")])[1]
    ten = OC.count(f, x, [torch.empty(128, 128, device="meta")] * 10)[1]
    assert one.flops == 2 * 64 * 128 * 128
    assert ten.flops == 10 * one.flops
    assert ten.hbm_bytes == 10 * one.hbm_bytes


def test_counts_only_the_traced_device_and_tracks_peak_bytes():
    """Ops on another device are not the program's; the peak counts the
    bytes allocated inside the mode, above the arguments."""
    x = torch.empty(1024, device="meta")
    with OC.OpCounter("meta", track_memory=True) as oc:
        torch.ones(8) + 1                 # a CPU op: not counted
        y = x * 2                         # 4 KiB
        z = y + 1                         # 4 KiB more
        del y
        w = z.view(32, 32)                # a view: free, no storage
        del z, w
    assert oc.cost.ops == 3               # mul, add, view
    assert oc.cost.hbm_bytes == 2 * (4096 + 4096)
    assert oc.peak_bytes == 2 * 4096
    assert oc.live_bytes == 0


def test_float64_ops_are_reported():
    x = torch.empty(16, dtype=torch.float64, device="meta")
    _, cost = OC.count(lambda t: (t.float() * 2).double(), x)
    assert cost.float64_ops == ["aten._to_copy.default"]
    assert TRL.check_no_f64(cost) == cost.float64_ops
    assert OC.count(lambda t: t.float() * 2, x)[1].float64_ops == []


def test_all_reduce_over_16_counts_its_ring_wire_bytes():
    got = _run("""
        import json, torch
        import torch.distributed._functional_collectives as fc
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.launch.mesh import fake_process_group
        from repro_torch.launch.opcost import OpCounter
        with fake_process_group(16):
            mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
            t = torch.empty(1000, device="meta")
            with OpCounter("meta") as oc:
                fc.all_reduce(t, "sum", mesh.get_group("model")) + 0
            print(json.dumps(oc.cost.to_dict()))
    """)
    assert got["coll_counts"] == {"all-reduce": 1}
    assert got["coll_out_bytes"] == 4000
    assert got["wire_bytes"] == pytest.approx(2 * 15 / 16 * 4000)
    assert got["flops"] == 0


def test_a_permute_counts_its_bytes_once_and_tops_the_wire_list():
    """An all_to_all_single that takes its whole output from one rank and
    sends its whole input to one (``models/sharding.py``'s permute of a
    weight's shard) is a collective-permute: n bytes on the wire for n
    bytes moved, where an all-to-all of the same output reads (N-1)/N of
    them; ``top_wire`` lists each by kind, group size, output shape and
    dtype, the largest first, with its count and the group's mesh axis
    ("world" for the default group)."""
    got = _run("""
        import json, torch
        import torch.distributed as dist
        import torch.distributed._functional_collectives as fc
        from repro_torch.launch.mesh import fake_process_group
        from repro_torch.launch.opcost import OpCounter
        with fake_process_group(16):
            t = torch.empty(256, 4, device="meta", dtype=torch.bfloat16)
            splits = [0] * 16
            splits[5] = 1024
            with OpCounter("meta") as oc:
                fc.all_to_all_single(t.reshape(-1), splits, splits,
                                     dist.group.WORLD) + 0
                fc.all_to_all_single(t, None, None, dist.group.WORLD) + 0
                fc.all_to_all_single(t, None, None, dist.group.WORLD) + 0
            print(json.dumps({"cost": oc.cost.to_dict(),
                              "top": oc.cost.top_wire()}))
    """)
    cost = got["cost"]
    assert cost["coll_counts"] == {"collective-permute": 1, "all-to-all": 2}
    assert cost["wire_bytes"] == pytest.approx(2048 + 2 * 15 / 16 * 2048)
    assert got["top"] == [
        ["all-to-all world n=16 (256, 4) bfloat16", 2 * 15 / 16 * 2048, 2],
        ["collective-permute world n=16 (1024,) bfloat16", 2048.0, 1]]


# ---------------------------------------------------------------------------
# unsharded FLOPs against repro's hlocost, one smoke config per family
# ---------------------------------------------------------------------------

FAMILY_ARCH = {"dense": "deepseek-coder-33b", "moe": "olmoe-1b-7b",
               "ssm": "mamba2-130m", "hybrid": "jamba-1.5-large-398b",
               "vlm": "internvl2-2b", "encdec": "whisper-medium"}
# |port / repro - 1| at most 1 %.  Measured: equal in every family and
# kind but training the two with the SSD scan, where the port counts
# fewer: ssm 0.99738 (196,608 FLOPs), hybrid 0.99857 (688,128).  XLA's
# compiled backward holds dots there whose counterparts in the port's
# autograd are not matmuls (which ones is not traced further).
FLOP_RTOL = 0.01


def _meta(tree):
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device="meta"), tree)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_unsharded_flops_match_repro_hlocost(family, kind):
    arch = FAMILY_ARCH[family]
    jc, tc = j_smoke_config(arch), smoke_config(arch)
    js, ts = JShapeSpec("x", 64, 2, kind), ShapeSpec("x", 64, 2, kind)
    if kind == "train":
        opt = JO.OptConfig()
        jfn = JS.make_train_step(jc, opt)
        jops = (JS.train_state_shapes(jc, opt), japi.input_specs(jc, js)[0])
    else:
        def jfn(params, batch):
            return japi.prefill(jc, params, batch["tokens"],
                                batch.get("frontend"))
        jops = (japi.param_shapes(jc), japi.input_specs(jc, js)[0])
    want = JHC.analyze_text(jax.jit(jfn).lower(*jops).compile().as_text()
                            ).flops
    tfn, shapes, _ = TD.build_cell(tc, ts)
    if kind == "train":       # smoke configs train float32 AdamW
        from repro_torch.train.optimizer import OptConfig
        from repro_torch.train.steps import (make_train_step,
                                             train_state_shapes)
        tfn = make_train_step(tc, OptConfig())
        shapes = (train_state_shapes(tc, OptConfig()), shapes[1])
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with OC.OpCounter("meta") as oc, grad:
        tfn(*(_meta(s) for s in shapes))
    assert want > 0
    assert oc.cost.flops == pytest.approx(want, rel=FLOP_RTOL)


# ---------------------------------------------------------------------------
# per-device argument bytes and fallbacks of every cell
# ---------------------------------------------------------------------------

def _import_repro_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS at import (for its own
    entry point); this process keeps its own."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as JD
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return JD


def _t_mesh(multi_pod):
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = production_layout(multi_pod)
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


def _j_layout(cfg, shape, multi_pod, rules):
    """repro's per-device argument bytes and fallbacks: its spec_for over
    its own operand shapes (it reads only the mesh's names and sizes),
    each leaf's shard shape from the spec."""
    JD = _import_repro_dryrun()
    dims, names = production_layout(multi_pod)
    sizes = dict(zip(names, dims))
    jm = types.SimpleNamespace(shape=sizes)
    _, op_shapes, op_axes, _ = JD.build_cell(cfg, shape)
    nbytes = 0
    with JSH.sharding_ctx(jm, rules):
        for shapes, axes in zip(op_shapes, op_axes):
            leaves = jax.tree.leaves(shapes)
            ax = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple))
            for x, a in zip(leaves, ax):
                spec = JSH.spec_for(x.shape, a)
                n = 1
                for i, d in enumerate(x.shape):
                    part = spec[i] if i < len(spec) else None
                    for name in ((part,) if isinstance(part, str)
                                 else (part or ())):
                        d //= sizes[name]
                    n *= d
                nbytes += n * np.dtype(x.dtype).itemsize
        fallbacks = [f"{s} {l} {n}->{a}" for s, l, n, a in
                     JSH.recorded_fallbacks()]
    return nbytes, fallbacks


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELLS,
                         ids=["__".join(c) for c in CELLS])
def test_cell_argument_bytes_and_fallbacks_match_repro(arch, shape_name,
                                                       mesh_name):
    JD = _import_repro_dryrun()
    multi = mesh_name == "multi"
    cfg, shape = get_config(arch), SHAPES[shape_name]
    jcfg, jshape = j_get_config(arch), J_SHAPES[shape_name]
    rules = TD.rules_for(shape, arch)
    assert rules == JD.rules_for(jshape, arch)
    assert TD.opt_for(cfg).__dict__ == JD.opt_for(jcfg).__dict__
    # the operands as the dry run places them: a dense, ssm, vlm or
    # encdec training cell's state by the trainer's own train_shardings
    _, _, _, got_b, got_f = TD.cell_layout(cfg, shape, _t_mesh(multi),
                                           rules)
    want_b, want_f = _j_layout(jcfg, jshape, multi, rules)
    assert got_b == want_b
    assert sorted(got_f) == sorted(want_f)


# ---------------------------------------------------------------------------
# model_flops and report rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_repro(arch, shape_name):
    got = TRL.model_flops(get_config(arch), SHAPES[shape_name], 256)
    want = JRL.model_flops(j_get_config(arch), J_SHAPES[shape_name], 256)
    assert got == want


_ROOF = {"compute_s": 0.0123, "memory_s": 0.0456, "collective_s": 0.0078,
         "dominant": "memory"}
REPORT_ROWS = {
    "ok": {"arch": "qwen1.5-32b", "shape": "train_4k", "mesh": "single",
           "status": "ok", "roofline": _ROOF, "arg_bytes_per_dev": 3e9,
           "temp_bytes_per_dev": 2.5e9, "out_bytes_per_dev": 1e6,
           "hbm_fit": True},
    "over": {"arch": "kimi-k2-1t-a32b", "shape": "train_4k",
             "mesh": "multi", "status": "ok",
             "roofline": dict(_ROOF, dominant="collective",
                              collective_s=0.9),
             "arg_bytes_per_dev": 9e10, "temp_bytes_per_dev": 1e10,
             "out_bytes_per_dev": 0, "hbm_fit": False},
    "skip": {"arch": "qwen1.5-32b", "shape": "long_500k", "mesh": "single",
             "status": "skip", "reason": "skipped (full-attention arch)"},
    "fail": {"arch": "olmoe-1b-7b", "shape": "train_4k", "mesh": "single",
             "status": "fail",
             "error": "aten.sort.stable: no sharding\n" + "x" * 200},
}


@pytest.mark.parametrize("row", list(REPORT_ROWS))
def test_report_rows_match_repro(row):
    r = REPORT_ROWS[row]
    assert TREP.fmt_row(r) == JREP.fmt_row(r)
    assert TREP.HEADER == JREP.HEADER


def test_report_reads_hbm_fit_against_80_gb(tmp_path, capsys):
    for i, r in enumerate(REPORT_ROWS.values()):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    TREP.main(["--art", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == TREP.HEADER.splitlines()[0]
    assert len([x for x in out if x.startswith("| ")]) == 1 + 4
    assert out[-1] == ("2 traced, 1 fit in 80 GB HBM/GPU; 1 skipped "
                       "(long_500k on full-attention archs).")


# ---------------------------------------------------------------------------
# dry-run cells end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "deepseek-coder-33b"])
def test_dryrun_decode_cell_end_to_end(arch, tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC}
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--arch", arch, "--shape", "decode_32k", "--mesh",
         "single", "--out", str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert time.monotonic() - t0 < 240
    r = json.loads((tmp_path / f"{arch}__decode_32k__single.json")
                   .read_text())
    assert r["status"] == "ok" and r["chips"] == 256
    rf = r["roofline"]
    assert rf["flops_per_dev"] > 0 and rf["memory_s"] > 0
    assert rf["dominant"] != "compute"
    assert r["f64_leaks"] == []
    assert r["hbm_fit"] and r["device"] == "cpu"
    # model FLOPs over all ranks' counted FLOPs: at best ~1, at worst the
    # 16-wide "model" axis repeating each product, with 10 % for work
    # outside model_flops; a count of the global program on each rank
    # would read ~1/256
    assert 1 / (16 * 1.1) <= r["useful_ratio"] <= 1.1
    assert r["top_flops"][0][1] > 0
    # the cache's sequence is sharded over "model": the softmax partials
    # and the row-parallel projections are reduced across ranks
    assert rf["wire_bytes_per_dev"] > 0
    cfg = get_config(arch)
    assert r["params"] == TD.api.param_count(cfg)
    assert r["model_flops"] == TRL.model_flops(cfg, SHAPES["decode_32k"],
                                               256)[0]
    row = TREP.fmt_row(r)
    assert row.startswith(f"| {arch} | decode_32k | single | ok |")


# ---------------------------------------------------------------------------
# the traced program on a real 2 x 2 mesh of gloo processes
# ---------------------------------------------------------------------------

_RANK = """\
import copy, json, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
RANK, STORE = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + STORE, rank=RANK,
                        world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.base import ShapeSpec, smoke_config
from repro_torch.launch.dryrun import allow_uneven_views
from repro_torch.models import api
from repro_torch.models.params import tree_flatten, tree_unflatten
from repro_torch.models.sharding import sharding_ctx, tree_shardings
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import (init_train_state, make_train_step,
                                     train_state_axes)

allow_uneven_views()
cfg = smoke_config("deepseek-coder-33b")
opt = OptConfig(warmup_steps=1)
state = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
state["step"] = torch.tensor(3, dtype=torch.int32)   # lr > 0
rng = np.random.default_rng(0)
gen = torch.Generator().manual_seed(1)
batch = {{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))
                             .astype(np.int32))
         for k in ("tokens", "targets")}}
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
step = make_train_step(cfg, opt)
ref = copy.deepcopy(state)
loss_r, m_r, g_r = step.accumulate(ref["params"], batch)
ref, om_r = step.update(ref, loss_r, m_r, g_r)


def place(tree, axes):
    sh = tree_flatten(tree_shardings(tree, axes, mesh))[0]
    flat, st = tree_flatten(tree)
    return tree_unflatten(st, [distribute_tensor(x, mesh, s.placements)
                               for x, s in zip(flat, sh)])


dstate = place(state, train_state_axes(cfg, opt))
dbatch = place(batch, api.input_specs(cfg, ShapeSpec("t", 32, 4,
                                                     "train"))[1])
sharded = sum(any(p.is_shard() for p in x.placements)
              for x in tree_flatten(dstate)[0])
with sharding_ctx(mesh), implicit_replication():
    loss, m, g = step.accumulate(dstate["params"], dbatch)
    dstate, om = step.update(dstate, loss, m, g)


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


# a decode step with the cache's sequence over "model" (the decode rules)
dcache = {{"k": torch.randn(2, 4, 64, 2, 16, generator=gen),
          "v": torch.randn(2, 4, 64, 2, 16, generator=gen),
          "len": torch.tensor([40, 5, 63, 17], dtype=torch.int32)}}
dtok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1))
                        .astype(np.int32))
ref_c = copy.deepcopy(dcache)
with torch.no_grad():
    logits_r, ref_c = api.decode_step(cfg, ref["params"], ref_c, dtok)
    rules = {{"kv_seq": "model"}}
    with sharding_ctx(mesh, rules):
        c_axes = api.cache_specs(cfg, 4, 64)[1]
        d_c = place(dcache, c_axes)
        d_tok = place({{"t": dtok}}, {{"t": ("batch", None)}})["t"]
        seq_sharded = d_c["k"].placements[1].is_shard(2)   # (L,B,S,..)
        with implicit_replication():
            logits, d_c = api.decode_step(cfg, dstate["params"], d_c, d_tok)


err = {{"loss": abs(float(full(loss)) - float(loss_r)),
        "grad_norm": abs(float(full(om["grad_norm"]))
                         - float(om_r["grad_norm"])),
        "sharded_leaves": int(sharded),
        "decode_logits": float((full(logits) - logits_r).abs().max()),
        "decode_cache": max(float((full(d_c[k]) - ref_c[k]).abs().max())
                            for k in ("k", "v")),
        "decode_len": bool(torch.equal(full(d_c["len"]), ref_c["len"])),
        "decode_slots": int((full(d_c["k"]) != dcache["k"]).any(-1).any(-1)
                            .sum()),
        "seq_sharded": bool(seq_sharded)}}
for name, a, b in (("grad", g, g_r), ("params", dstate["params"],
                                      ref["params"]),
                   ("m", dstate["opt"]["m"], ref["opt"]["m"]),
                   ("v", dstate["opt"]["v"], ref["opt"]["v"])):
    pairs = list(zip(tree_flatten(a)[0], tree_flatten(b)[0]))
    err[name] = max(float((full(x) - y).abs().max()) for x, y in pairs)
    err[name + "_scale"] = max(float(y.abs().max()) for _, y in pairs)
if RANK == 0:
    print(json.dumps(err))
dist.destroy_process_group()
"""

# float32 at smoke widths; the sharded step sums in other orders.
# Measured: loss 4.8e-7, grad 6.3e-6 (of 1.39), grad_norm 1.1e-5,
# params 8.6e-6 (lr 3e-4 a step: a near-zero gradient's update,
# m / sqrt(v), moves with its last bits), m 6.1e-8, v 3.4e-9.
GLOO_TOL = {"loss": 1e-5, "grad": 2e-5, "grad_norm": 1e-4,
            "params": 3e-5, "m": 1e-6, "v": 1e-7}
# float32 logits and written cache rows of a decode step over a
# sequence-sharded cache (the k/v projections and the softmax's partial
# sums reduce across ranks).  Measured: logits 1.9e-6, cache 1.2e-5.
DECODE_TOL = 1e-4


def test_sharded_dense_step_on_2x2_gloo_equals_single_process(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(_RANK.format(src=SRC))
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(store)], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    err = json.loads(outs[0][0].strip().splitlines()[-1])
    assert err["sharded_leaves"] > 0
    for k, tol in GLOO_TOL.items():
        assert err[k] <= tol, (k, err)
    # the decode step's cache written shard by shard: each row's slot in
    # whichever model rank's slice of the sequence holds its position
    assert err["seq_sharded"] and err["decode_len"]
    assert err["decode_slots"] == 2 * 4          # one a layer and row
    assert err["decode_cache"] <= DECODE_TOL
    assert err["decode_logits"] <= DECODE_TOL


# ---------------------------------------------------------------------------
# routing: stand-ins never reach a launch
# ---------------------------------------------------------------------------

def test_fake_cuda_tensors_take_the_plain_version(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops

    def refuse(*a, **k):
        raise AssertionError("a stand-in reached the kernel launch")
    monkeypatch.setattr(fa_kernel, "flash_attention", refuse)
    with FakeTensorMode():
        q = torch.empty(1, 128, 8, 16, device="cuda")
        k = torch.empty(1, 128, 2, 16, device="cuda")
        assert not K.on_cuda(q)
        K.site_tape_start()
        # non-causal: a CPU build of torch makes no fake CUDA arange
        out = fa_ops.flash_attention(q, k, k, False)
        sites = K.site_tape_stop()
    assert out.shape == q.shape and out.device.type == "cuda"
    assert sites == {"flash_attention": 1}
    assert not K.on_cuda(torch.empty(2, device="meta"))
    assert not K.on_cuda(torch.empty(2))


def test_dtensors_route_by_their_local_shard():
    """A DTensor is routed as its local shard is: over ``meta`` or a
    FakeTensor on "cuda" (the dry run's stand-ins) it takes the plain
    version, over a CPU shard too; and a kernel's operand check refuses
    any DTensor, so one over real CUDA shards (which the routing sends to
    the kernel) raises rather than launch on it."""
    got = _run("""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch import kernels as K
        from repro_torch.launch.mesh import fake_process_group, make_mesh
        out = {}
        with fake_process_group(2):
            mesh = make_mesh((2,), ("model",), "cpu")

            def dt(local):
                return DTensor.from_local(local, mesh, [Replicate()],
                                          run_check=False)
            with FakeTensorMode():
                fake = torch.empty(4, device="cuda")
            out["fake_cuda_shard"] = K.on_cuda(dt(fake))
            out["meta_shard"] = K.on_cuda(dt(torch.empty(4, device="meta")))
            out["cpu_shard"] = K.on_cuda(dt(torch.zeros(4)))
            try:
                K.check_same_cuda(dt(torch.zeros(4)))
                out["refused"] = None
            except TypeError as e:
                out["refused"] = str(e)
        print(json.dumps(out))
    """)
    assert got["fake_cuda_shard"] is False
    assert got["meta_shard"] is False and got["cpu_shard"] is False
    assert got["refused"] and "DTensor" in got["refused"]


def test_prefill_trace_records_its_flash_sites():
    from repro_torch import kernels as K
    cfg = smoke_config("deepseek-coder-33b")
    fn, shapes, _ = TD.build_cell(cfg, ShapeSpec("p", 64, 2, "prefill"))
    K.site_tape_start()
    with torch.no_grad():
        fn(*(_meta(s) for s in shapes))
    assert K.site_tape_stop() == {"flash_attention": cfg.num_layers}
