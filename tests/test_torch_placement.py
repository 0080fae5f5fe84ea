"""Each weight placed at its use, as ``repro``'s partitioned program places
it (``models/sharding.py``: ``use_weight``, ``product_operands``,
``on_own_rows``), held to ``repro`` and to one process on the CPU.

  * Five decode cells of the dry run side by side with ``repro``'s
    (``scripts/dryrun_side_by_side.py``, each side in its own
    interpreter): per-device FLOPs and collective wire bytes within the
    bounds below, argument bytes and fallbacks equal to ``repro``'s.
  * The helpers are the identity (the cast alone) on plain tensors and on
    a (1, 1) mesh, and dispatch no DTensor op there.
  * On a 2 x 2 gloo mesh, products placed by each rule (the FSDP gather
    with the "model" shard kept, the split contraction of a weight whole
    over "model", the rows split over "model" where they divide), the
    attention on each rank's rows and heads and the chunked SSD on each
    rank's rows or heads give one process's forward and gradients, and a
    product without autograd (a decode step's) one process's forward,
    within the production layout's limits
    (``scripts/production_layout_2x2.py`` TOL).
"""

import concurrent.futures
import functools
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.models import sharding as SH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SBS = _script("dryrun_side_by_side")
PL = _script("production_layout_2x2")

# per-device FLOPs of each cell before each weight was placed at its use
# (the port at torch 2.13.0+cpu; repro's are XLA's, read beside them)
BEFORE = {"whisper-medium": 7.025e9, "internvl2-2b": 1.072e10,
          "qwen1.5-32b": 1.314e11}
# per-device collective wire bytes of each cell before the decode moves
# kept the rows on their ranks and moved a weight's FSDP shard onto
# "model" by a permute (torch 2.13.0+cpu): none may rise
WIRE_BEFORE = {("mamba2-130m", "single"): 237_584_640,
               ("mamba2-130m", "multi"): 164_919_376,
               ("whisper-medium", "single"): 614_797_500,
               ("internvl2-2b", "single"): 1_098_916_860,
               ("qwen1.5-32b", "single"): 15_549_936_480}
# the cells whose wire bytes are held at or below repro's
WIRE_AT_MOST_REPRO = {"mamba2-130m", "qwen1.5-32b"}
DECODE_CELLS = [("mamba2-130m", "single"), ("whisper-medium", "single"),
                ("internvl2-2b", "single"), ("qwen1.5-32b", "single"),
                ("mamba2-130m", "multi")]
# XLA's memory analysis of repro's whisper cell reads 29,540,608 argument
# bytes a device fewer than the operands' shards (tests/test_torch_launch.py
# holds both packages' per-operand counts equal); the port's are held to
# their reading before the placement changed
ARG_BYTES = {"whisper-medium": 2_878_950_208}


def _side_by_side(tmp, cell):
    arch, mesh = cell
    kw = dict(arch=arch, shape="decode_32k", multi=mesh == "multi", tmp=tmp,
              cfg=None)
    return (SBS.counts(SBS._run(SBS._REPRO.format(**kw))),
            SBS.counts(SBS._run(SBS._PORT.format(**kw))))


@pytest.fixture(scope="module")
def decode_cells(tmp_path_factory):
    """The decode_32k cells in both packages, two cells at a time, each
    side in its own interpreter."""
    run = functools.partial(_side_by_side,
                            str(tmp_path_factory.mktemp("repro_art")))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return dict(zip(DECODE_CELLS, pool.map(run, DECODE_CELLS)))


@pytest.mark.parametrize("cell", DECODE_CELLS, ids="-".join)
def test_decode_cell_partitions_as_repro(decode_cells, cell):
    """mamba2's useful ratio at least 0.80 (every product on the rank's
    own 8 rows, the head's contraction split over "model"); the others
    below their per-device FLOPs before and within 1.5x of repro's; the
    argument bytes and the fallbacks are repro's.  The collective wire
    bytes a device at most the cell's before the decode moves
    (WIRE_BEFORE), mamba2's (single and multi) and qwen's at most
    repro's; and no all-gather in ``top_wire`` moves a float32 state or
    score tensor (three or more dimensions) of the step's rows (its
    output stacks 16 shards of 8 rows, 4 multi, along dimension 0: 128,
    64): the SSM state and the attention scores stay where they lie, the
    state's inner dimension and the scores' sequence on their "model"
    shards, their rows on their "data" rank."""
    arch, mesh = cell
    repro, port = decode_cells[cell]
    assert repro["status"] == port["status"] == "ok"
    assert port["wire_bytes_per_dev"] <= WIRE_BEFORE[cell], port
    if arch in WIRE_AT_MOST_REPRO:
        assert port["wire_bytes_per_dev"] <= repro["wire_bytes_per_dev"], (
            port["wire_bytes_per_dev"], repro["wire_bytes_per_dev"])
    rows = 128 if mesh == "single" else 64
    for key, _, _ in port["top_wire"]:
        kind, _, _, shape = key.split(" ", 3)
        dims = [int(v) for v in shape[1:shape.index(")")].split(",") if v]
        assert not (kind == "all-gather" and shape.endswith("float32")
                    and len(dims) >= 3 and dims[0] == rows), port["top_wire"]
    assert port["arg_bytes_per_dev"] == ARG_BYTES.get(
        arch, repro["arg_bytes_per_dev"])
    assert port["fallbacks"] == repro["fallbacks"]
    if arch == "mamba2-130m":
        assert port["useful_ratio"] >= 0.80, port
    else:
        assert port["flops_per_dev"] < BEFORE[arch]
        assert port["flops_per_dev"] <= 1.5 * repro["flops_per_dev"], (
            port["flops_per_dev"], repro["flops_per_dev"])


# ---------------------------------------------------------------------------
# the identity where nothing is sharded
# ---------------------------------------------------------------------------

def test_helpers_are_the_cast_on_plain_tensors():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 6, generator=g)
    x = torch.randn(4, 3, 8, generator=g)
    assert SH.use_weight(w, w.dtype) is w
    assert torch.equal(SH.use_weight(w, torch.bfloat16),
                       w.to(torch.bfloat16))
    xo, wo = SH.product_operands(x, w, w.dtype, ((0, -1),))
    assert xo is x and wo is w
    assert SH._contract_with(x, w, ((0, -1),)) is x
    q = x[..., None]
    assert SH.on_own_rows(lambda *a: a, (q, q, q), ((0, 2),) * 3,
                          ((0, 2),), trade_heads=False) is None
    assert SH.on_own_rows(lambda *a: a, (x,), ((0, 1),), ((0, 1),)) is None


_ONE_RANK = """
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.models import sharding as SH

mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
g = torch.Generator().manual_seed(0)
R = [Replicate(), Replicate()]
w = DTensor.from_local(torch.randn(8, 6, generator=g), mesh, R)
x = DTensor.from_local(torch.randn(4, 3, 8, generator=g), mesh, R)
q = DTensor.from_local(torch.randn(2, 3, 4, 5, generator=g), mesh, R)
from torch.utils._python_dispatch import TorchDispatchMode
calls = []


class Seen(TorchDispatchMode):
    # every op dispatched on a DTensor, handed back to DTensor
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            calls.append(str(func))
            return NotImplemented
        return func(*args, **(kwargs or {}))


out = {}
with SH.sharding_ctx(mesh), Seen():
    out["use_weight"] = SH.use_weight(w, w.dtype) is w
    xo, wo = SH.product_operands(x, w, w.dtype, ((0, -1),))
    out["product_operands"] = xo is x and wo is w
    out["contract_with"] = SH._contract_with(x, w, ((0, -1),)) is x
    out["attention"] = SH.on_own_rows(lambda *a: a, (q, q, q),
                                      ((0, 2),) * 3, ((0, 2),),
                                      trade_heads=False) is None
    out["on_own_rows"] = SH.on_own_rows(
        lambda *a: a, (q,), ((0, 2),), ((0, 2),)) is None
    out["dispatched"] = list(calls)
    cast = SH.use_weight(w, torch.bfloat16)
    out["cast_ops"] = calls[len(out["dispatched"]):]
    out["cast_equal"] = bool(torch.equal(cast.to_local(),
                                         w.to_local().to(torch.bfloat16)))
print(json.dumps(out))
"""


def test_helpers_dispatch_nothing_on_a_one_by_one_mesh(tmp_path):
    """On a (1, 1) mesh (phases 18 and 19 on one card) every helper hands
    back its input and dispatches no DTensor op; a cast is the one
    ``_to_copy``."""
    code = (f"import json, os, sys, torch\nsys.path.insert(0, {SRC!r})\n"
            "import torch.distributed as dist\n"
            f"dist.init_process_group('gloo', init_method="
            f"'file://{tmp_path}/store', rank=0, world_size=1)\n"
            + textwrap.dedent(_ONE_RANK)
            + "dist.destroy_process_group()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("use_weight", "product_operands", "contract_with",
                "attention", "on_own_rows", "cast_equal"):
        assert out[key], (key, out)
    assert out["dispatched"] == []
    assert out["cast_ops"] == ["aten._to_copy.default"]


# ---------------------------------------------------------------------------
# 2 x 2 gloo: each rule gives one process's forward and gradients
# ---------------------------------------------------------------------------

_RANKS = """
import json, os, sys
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
RANK, STORE, OUT = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + STORE, rank=RANK,
                        world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import init_tree
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import sharding as SH

SH.allow_uneven_views()
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def placed(t, *logical):
    return distribute_tensor(t, mesh, SH.placements(
        SH.spec_for(t.shape, logical, mesh), mesh))


def case(fn, inputs, logical):
    # fn on the inputs placed by their rules and on plain copies; the
    # largest |difference| of the output and of each input's gradient,
    # over the largest |value| of one process's
    plain = [t.clone().requires_grad_(t.is_floating_point())
             for t in inputs]
    y = fn(*plain)
    r = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
    (y * r).sum().backward()
    dts = [placed(t, *lg).requires_grad_(t.is_floating_point())
           for t, lg in zip(inputs, logical)]
    with SH.sharding_ctx(mesh):
        yd = fn(*dts)
    (yd * distribute_tensor(r, mesh, yd.placements)).sum().backward()
    err = {{"out": float((yd.full_tensor() - y).abs().max()
                          / y.abs().max())}}
    for i, (a, b) in enumerate(zip(dts, plain)):
        if b.grad is not None:
            err[f"grad{{i}}"] = float((a.grad.full_tensor() - b.grad).abs()
                                      .max() / b.grad.abs().max())
    return err


def forward_case(fn, inputs, logical):
    # fn without autograd, as a decode step runs: the output's error
    y = fn(*inputs)
    with torch.no_grad(), SH.sharding_ctx(mesh):
        yd = fn(*[placed(t, *lg) for t, lg in zip(inputs, logical)])
    return {{"out": float((yd.full_tensor() - y).abs().max()
                         / y.abs().max())}}


class Collectives(TorchDispatchMode):
    # the collectives DTensor and the helpers issue, below DTensor
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace.startswith("_c10d_functional"):
            self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {{}}))


def moved(fn, *args):
    # the collectives of one call
    with Collectives() as seen:
        out = fn(*args)
    return out, seen.names


g = torch.Generator().manual_seed(0)
rows4 = torch.randn(4, 3, 8, generator=g)
rows2 = torch.randn(2, 3, 8, generator=g)


def mlp(x, w_in, b_in, w_out, b_out):
    return L.mlp(CFG, {{"w_in": w_in, "b_in": b_in, "w_out": w_out,
                      "b_out": b_out}}, x)


CFG = ModelConfig(name="t", family="dense", num_layers=1, d_model=8,
                  num_heads=4, num_kv_heads=2, head_dim=4, d_ff=6,
                  vocab_size=7, mlp_variant="gelu", dtype="float32",
                  ssm_chunk=2)
res = {{}}
# the FSDP axis gathered, the "model" shard of the heads kept
res["gather_keep_model"] = case(
    lambda x, w: L.proj_heads(x, w, "heads"),
    [rows4, torch.randn(8, 4, 4, generator=g)],
    [("batch",), ("embed", "heads", "head_dim")])
# kv heads whole over "model": a decode step's 2 rows (1 a
# data rank) do not divide over it, so the contraction splits
res["split_contraction"] = case(
    lambda x, w: L.proj_heads(x, w, "kv_heads"),
    [rows2, torch.randn(8, 2, 4, generator=g)],
    [("batch",), ("embed", "kv_heads", "head_dim")])
# ... and the trainer's 4 rows (2 a data rank) split over it instead
res["split_rows"] = case(
    lambda x, w: L.proj_heads(x, w, "kv_heads"),
    [rows4, torch.randn(8, 2, 4, generator=g)],
    [("batch",), ("embed", "kv_heads", "head_dim")])
# the head: a vocabulary of 7 does not divide over "model"
res["head_fallback"] = case(
    lambda x, w: L.unembed(CFG, {{"tok": w}}, x),
    [rows2, torch.randn(7, 8, generator=g)],
    [("batch",), ("vocab", "embed")])
# ... and without autograd: the weight's FSDP shard gathered as with it
res["split_contraction_no_grad"] = forward_case(
    lambda x, w: L.proj_heads(x, w, "kv_heads"),
    [rows2, torch.randn(8, 2, 4, generator=g)],
    [("batch",), ("embed", "kv_heads", "head_dim")])
# the head's FSDP shard over "data" moved onto "model" for its split
# contraction (a vocabulary of 7 is whole over "model") by a permute, not
# a gather of the whole head, with autograd and without
seen = {{}}


def head(x, w):
    out, names = moved(lambda: L.unembed(CFG, {{"tok": w}}, x))
    if hasattr(w, "placements"):
        seen[torch.is_grad_enabled()] = names
    return out


res["permute"] = case(head, [rows2, torch.randn(7, 8, generator=g)],
                      [("batch",), ("vocab", "embed")])
res["permute_no_grad"] = forward_case(
    head, [rows2, torch.randn(7, 8, generator=g)],
    [("batch",), ("vocab", "embed")])
res["permute"]["collectives"] = seen[True]
res["permute_no_grad"]["collectives"] = seen[False]
# an MLP: gathered up-projection, Partial down-projection, biases
res["mlp"] = case(mlp, [rows4, torch.randn(8, 6, generator=g),
                        torch.randn(6, generator=g),
                        torch.randn(6, 8, generator=g),
                        torch.randn(8, generator=g)],
                  [("batch",), ("embed", "ffn"), ("ffn",), ("ffn", "embed"),
                   ("embed",)])
# attention on each rank's rows and heads
res["attention"] = case(
    lambda q, k, v: L._sdpa(CFG, q, k, v, None, None, None, None, True),
    [torch.randn(4, 3, 4, 4, generator=g),
     torch.randn(4, 3, 2, 4, generator=g),
     torch.randn(4, 3, 2, 4, generator=g)],
    [("batch", None, "heads"), ("batch", None, "kv_heads"),
     ("batch", None, "kv_heads")])


def ssd(xh, dt, b, c, a):
    return S.ssd_chunked(CFG, xh, dt, b, c, a)[0]


def ssd_inputs(rows):
    return [torch.randn(rows, 4, 4, 2, generator=g),
            torch.rand(rows, 4, 4, generator=g) + 0.1,
            torch.randn(rows, 4, 4, generator=g),
            torch.randn(rows, 4, 4, generator=g),
            -torch.rand(4, generator=g) - 0.1]


SSD_AXES = [("batch", None, "ssm_heads"), ("batch", None, "ssm_heads"),
            ("batch", None, "state"), ("batch", None, "state"),
            ("ssm_heads",)]
# the SSD on each rank's rows (4 rows divide over data and model) ...
res["ssd_rows"] = case(ssd, ssd_inputs(4), SSD_AXES)
# ... or, 2 rows, on its heads: B and C used whole, Partial gradients
res["ssd_heads"] = case(ssd, ssd_inputs(2), SSD_AXES)
# a decode step of an SSM whose 3 heads do not divide over "model" (as
# mamba2-130m's 24 over 16): the state's rows stay on their data rank,
# and it leaves on the cache's placements; and the decode softmax over a
# sequence sharded over "model"
SCFG = ModelConfig(name="s", family="ssm", num_layers=1, d_model=6,
                   num_heads=1, num_kv_heads=1, head_dim=4, d_ff=4,
                   vocab_size=7, dtype="float32", ssm_state=4,
                   ssm_headdim=4, ssm_chunk=2)
SP = S.ssm_specs(SCFG)
sp = init_tree(SP, g, "float32")
CACHE_SHAPES, CACHE_AXES = S.ssm_cache_specs(SCFG, 2, torch.float32)
cache0 = {{k: torch.randn(v.shape, generator=g) for k, v in
          CACHE_SHAPES.items()}}
xdec = torch.randn(2, 1, 6, generator=g)


def ssm_decode(x, *leaves):
    n = len(SP)
    p = dict(zip(SP, leaves[:n]))
    cache = dict(zip(CACHE_SHAPES, leaves[n:]))
    out, new = S.ssm_decode_step(SCFG, p, x, cache)
    seen["state_placements"] = [str(tuple(new["state"].placements)),
                                str(tuple(cache["state"].placements))] \
        if hasattr(new["state"], "placements") else None
    return torch.cat([out.reshape(-1), new["state"].reshape(-1)])


res["ssm_decode_no_grad"] = forward_case(
    ssm_decode, [xdec] + list(sp.values()) + list(cache0.values()),
    [("batch",)] + [v.axes for v in SP.values()]
    + [CACHE_AXES[k] for k in CACHE_SHAPES])
res["ssm_decode_no_grad"]["state_placements"] = seen["state_placements"]
res["softmax_sharded_no_grad"] = forward_case(
    SH.softmax_last, [torch.randn(2, 3, 1, 1, 8, generator=g) * 4],
    [("batch", None, None, None, "heads")])
if RANK == 0:
    with open(os.path.join(OUT, "placement.json"), "w") as fh:
        json.dump(res, fh)
dist.destroy_process_group()
"""


def test_placed_products_match_one_process_on_a_2x2_mesh(tmp_path):
    """Forward and every input's gradient of each placement rule within
    the production layout's limits of one process's (TOL: loss for the
    output, m for the gradients, which m follows); a case without
    autograd has its output alone."""
    script = tmp_path / "ranks.py"
    script.write_text(textwrap.dedent(_RANKS.format(src=SRC)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store"),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT) for r in range(4)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    res = json.loads((tmp_path / "placement.json").read_text())
    assert len(res) == 13
    for name in ("permute", "permute_no_grad"):
        # the head moved by one all-to-all (a permute), none gathered it
        seen = res[name].pop("collectives")
        assert seen.count("all_to_all_single") == 1, (name, seen)
        assert "all_gather_into_tensor" not in seen, (name, seen)
    # the SSM decode state leaves on the cache's placements
    state, cache = res["ssm_decode_no_grad"].pop("state_placements")
    assert state == cache == "(Shard(dim=0), Replicate())", (state, cache)
    for name, err in res.items():
        assert err["out"] <= PL.TOL["loss"], (name, err)
        grads = {k: v for k, v in err.items() if k != "out"}
        assert bool(grads) != name.endswith("_no_grad"), name
        for k, v in grads.items():
            assert np.isfinite(v) and v <= PL.TOL["m"], (name, k, err)
