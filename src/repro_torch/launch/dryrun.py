"""Multi-pod dry run of the port: trace every (architecture x input shape)
cell's step against the production mesh (16 x 16 single-pod and 2 x 16 x
16 multi-pod) without allocating, and cost it against the H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch mamba2-130m --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu

The port of ``repro.launch.dryrun``.  ``repro`` lowers and compiles each
cell with ``ShapeDtypeStruct`` operands against 256 or 512 placeholder
devices and reads XLA's memory and cost analyses.  The port has no
compiler to ask, so it runs the step once, as one rank of the mesh:

  * a fake process group of 256 or 512 ranks (``mesh.fake_process_group``)
    carries the production ``DeviceMesh``; its collectives move nothing;
  * every operand is a ``DTensor`` placed by ``tree_shardings`` under the
    cell's rules (a training cell's state on the production layout by
    the trainer's own ``train_shardings``: ``cell_layout``), over a
    ``meta`` tensor of this rank's local shape: no
    memory is allocated and no kernel launches (the hand kernels' routing
    sends stand-ins to their plain versions, and each site the trace
    passes is counted in ``kernels``);
  * the step runs once, under ``sharding_ctx(mesh, rules)``: value,
    gradient and AdamW update for ``train_4k`` (the trainer's
    ``TrainStep`` on the mesh, every family's, MoE routing included),
    ``api.prefill`` or ``api.decode_step``.  DTensor's sharding
    propagation inserts the collectives, as GSPMD does for ``repro``; a
    plain tensor the model makes (positions, masks) is taken as
    replicated (``implicit_replication``);
  * ``launch/opcost.py`` counts, below DTensor, the local ops each device
    runs (FLOPs, HBM bytes, collective wire bytes) and the peak of the
    bytes they keep alive; ``launch/roofline.py`` turns that into the
    three terms.  ``top_flops`` lists the matmuls that weigh most, by
    local shapes: where ``useful_ratio`` is far below 1, it shows which
    operand DTensor left unsharded.  ``top_wire`` lists the collectives
    that move most (kind, group size, output shape and dtype; wire
    bytes a device; count): an all-gather whose output holds a whole
    dimension that the operands shard is a tensor leaving its ranks.

An op DTensor has no sharding strategy for fails the cell, with the op's
name first in ``error``; nothing is replicated in its place.  A ``view``
whose sharded dimension does not split evenly (56 heads over 16 model
ranks), or an einsum's flatten that torch 2.11 cannot apply to the
shards as they lie, is redistributed first, as ``reshape`` is, rather
than refused (``models.sharding.allow_uneven_views``): the collective it
costs is counted.

Artifacts go to ``launch_artifacts/dryrun_torch/`` (``report.py`` renders
them); ``--all`` runs each cell in a fresh interpreter, since a process
group is process-wide.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (H100, fake_process_group, make_mesh,
                                     production_layout)
from repro_torch.launch.opcost import OpCounter
from repro_torch.models import api
from repro_torch.models.params import tree_flatten, tree_unflatten
from repro_torch.models.sharding import (allow_uneven_views,
                                         live_placements,
                                         recorded_fallbacks, sharding_ctx,
                                         tree_shardings)
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import (make_train_step, train_shardings,
                                     train_state_axes, train_state_shapes)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "launch_artifacts", "dryrun_torch")


def opt_for(cfg) -> OptConfig:
    """Memory preset: the bf16 (100B+) archs get factored-v bf16 Adam."""
    huge = cfg.param_dtype == "bfloat16"
    return OptConfig(state_dtype="bfloat16" if huge else "float32",
                     factored_v=huge)


def rules_for(shape, arch: str):
    """Per-shape sharding-rule overrides.

    decode_32k: the KV cache dominates — shard its sequence dim over
    'model' (flash-decoding style; softmax partials all-reduce).
    long_500k: batch=1, so both non-trivial axes go to the sequence
    (attention layers of hybrids) / heads stay on 'model' for SSM.
    """
    if shape.kind != "decode":
        return {}
    if shape.name == "long_500k":
        return {"kv_seq": ("data", "model"), "batch": None}
    return {"kv_seq": "model"}


def build_cell(cfg, shape, microbatches: int = 1,
               opt: OptConfig | None = None, mesh=None):
    """Returns (fn, operand shapes, operand logical axes): the shapes are
    ``meta`` tensors or ``TensorSpec``s.  ``opt`` replaces ``opt_for``'s
    preset for a training cell, whose step is the trainer's own
    ``TrainStep`` on ``mesh``."""
    if shape.kind == "train":
        opt = opt or opt_for(cfg)
        step = make_train_step(cfg, opt, microbatches=microbatches,
                               mesh=mesh)
        b_shapes, b_axes = api.input_specs(cfg, shape)
        return (step, (train_state_shapes(cfg, opt), b_shapes),
                (train_state_axes(cfg, opt), b_axes))

    p_shapes = api.param_shapes(cfg)
    p_axes = api.param_axes(cfg)
    b_shapes, b_axes = api.input_specs(cfg, shape)
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return api.prefill(cfg, params, batch["tokens"],
                               batch.get("frontend"))

        return prefill_fn, (p_shapes, b_shapes), (p_axes, b_axes)

    def decode_fn(params, cache, tokens):
        return api.decode_step(cfg, params, cache, tokens)

    return (decode_fn, (p_shapes, b_shapes["cache"], b_shapes["tokens"]),
            (p_axes, b_axes["cache"], b_axes["tokens"]))


def local_shape(shape: Sequence[int], placements, mesh) -> Tuple[int, ...]:
    """This rank's shard of ``shape`` (every sharded dimension divides:
    ``spec_for`` replicates one that does not)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(dim)
    return tuple(out)


def operand_layout(op_shapes, op_axes, mesh, rules=None, state=None):
    """(shardings, per-device argument bytes, fallbacks) of the operands
    on ``mesh`` under ``rules`` (the cell's overrides of the defaults).
    ``state`` = (cfg, opt) of a training cell on the production layout:
    its first operand, the train state, is placed by the trainer's own
    ``train_shardings``."""
    with sharding_ctx(mesh, rules):
        shardings = tuple(
            train_shardings(*state, mesh) if i == 0 and state else
            tree_shardings(s, a)
            for i, (s, a) in enumerate(zip(op_shapes, op_axes)))
        fallbacks = [f"{s} {l} {n}->{a}" for s, l, n, a in
                     recorded_fallbacks()]
    nbytes = 0
    for shapes, shard in zip(op_shapes, shardings):
        for x, s in zip(tree_flatten(shapes)[0], tree_flatten(shard)[0]):
            n = 1
            for d in local_shape(tuple(x.shape), s.placements, mesh):
                n *= d
            nbytes += n * x.dtype.itemsize
    return shardings, nbytes, fallbacks


def cell_layout(cfg, shape, mesh, rules=None, microbatches: int = 1,
                opt: OptConfig | None = None):
    """(fn, operand shapes, shardings, per-device argument bytes,
    fallbacks) of one cell on ``mesh``.  A training cell runs the
    trainer's step on the mesh with the state on ``train_shardings``
    (a ``moe_ep`` config's too): what the dry run prices is what the
    trainer runs."""
    train = shape.kind == "train"
    fn, op_shapes, op_axes = build_cell(cfg, shape, microbatches, opt,
                                        mesh if train else None)
    state = (cfg, opt or opt_for(cfg)) if train else None
    shardings, nbytes, fallbacks = operand_layout(op_shapes, op_axes, mesh,
                                                  rules, state)
    return fn, op_shapes, shardings, nbytes, fallbacks


def stand_ins(shapes, shardings):
    """A DTensor of each leaf's global shape over a ``meta`` tensor of
    this rank's shard."""
    from torch.distributed.tensor import DTensor

    def one(x, s):
        shape = tuple(x.shape)
        local = torch.empty(local_shape(shape, s.placements, s.mesh),
                            dtype=x.dtype, device="meta")
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, s.mesh,
                                  live_placements(s.placements, s.mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    flat, struct = tree_flatten(shapes)
    return tree_unflatten(struct, [one(x, s) for x, s in
                                   zip(flat, tree_flatten(shardings)[0])])


def _local_storages(leaves) -> Dict[int, int]:
    """{storage id: bytes} of the local shards of some tensors."""
    out = {}
    for x in leaves:
        if isinstance(x, torch.Tensor):
            loc = x.to_local() if hasattr(x, "to_local") else x
            st = loc.untyped_storage()
            out[id(st)] = loc.numel() * loc.element_size()
    return out


def trace(fn, operands, kind: str) -> Dict[str, Any]:
    """Run ``fn(*operands)`` once (DTensors over ``meta`` shards) under the
    op counter; its cost, peak bytes, outputs' bytes and kernel sites."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import site_tape_start, site_tape_stop
    args_st = _local_storages(tree_leaves(operands))
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    site_tape_start()
    t0 = time.perf_counter()
    try:
        with OpCounter("meta", track_memory=True) as oc, \
                implicit_replication(), grad:
            out = fn(*operands)
    finally:
        sites = site_tape_stop()
    trace_s = time.perf_counter() - t0
    outs = {k: v for k, v in _local_storages(tree_leaves(out)).items()
            if k not in args_st}
    return {"cost": oc.cost, "peak_bytes": oc.peak_bytes,
            "out_bytes": sum(outs.values()), "kernels": sites,
            "trace_s": trace_s}


def _failed_op(exc: BaseException) -> Optional[str]:
    """The aten op DTensor could not shard, from its error chain."""
    e: Optional[BaseException] = exc
    while e is not None:
        msg = str(e)
        for pat in (r"Operator (\S+) does not have a sharding strategy",
                    r"Sharding propagation failed for ([\w.]+)"):
            m = re.search(pat, msg)
            if m:
                return m.group(1)
        e = e.__cause__ or e.__context__
    return None


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, tag: str = "",
             rule_overrides: dict | None = None,
             cfg_overrides: dict | None = None, device: str = "cuda",
             shape: ShapeSpec | None = None,
             mesh_shape: Sequence[int] | None = None,
             opt: OptConfig | None = None) -> dict:
    """One dry-run cell.  ``tag`` + overrides support variants: they
    re-trace the same cell with other sharding rules / config knobs and
    land in tagged artifacts.  ``shape`` (a ShapeSpec named
    ``shape_name``) and ``mesh_shape`` (over ("data", "model")) replace
    the registered shape and the production mesh, and ``opt`` the
    optimizer preset, for a cell cut to one card."""
    cfg = get_config(arch)
    microbatches = 1
    if cfg_overrides:
        cfg_overrides = dict(cfg_overrides)
        microbatches = cfg_overrides.pop("_microbatches", 1)
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
    shape = shape or SHAPES[shape_name]
    mesh_name = ("multi" if multi_pod else "single") + \
        (f"@{tag}" if tag else "")
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "ok", "tag": tag, "device": device,
              "overrides": {"rules": rule_overrides or {},
                            "cfg": cfg_overrides or {}}}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        result.update(status="skip", reason=why)
        return result

    if mesh_shape is None:
        dims, axes = production_layout(multi_pod)
    else:
        dims, axes = tuple(mesh_shape), ("data", "model")
    rules = rules_for(shape, arch)
    if rule_overrides:
        rules.update({k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in rule_overrides.items()})
    chips = 1
    for d in dims:
        chips *= d
    allow_uneven_views()
    with fake_process_group(chips):
        mesh = make_mesh(dims, axes, device)
        fn, op_shapes, shardings, arg_b, fallbacks = cell_layout(
            cfg, shape, mesh, rules, microbatches, opt)
        operands = tuple(stand_ins(s, sh)
                         for s, sh in zip(op_shapes, shardings))
        with sharding_ctx(mesh, rules):
            try:
                tr = trace(fn, operands, shape.kind)
            except Exception as e:
                op = _failed_op(e)
                head = (f"{op}: no sharding" if op else
                        f"{type(e).__name__}: {str(e).splitlines()[0]}")
                result.update(status="fail", fail_op=op, chips=chips,
                              error=head + "\n" +
                              traceback.format_exc()[-4000:])
                return result
            for s, l, n, a in recorded_fallbacks():
                f = f"{s} {l} {n}->{a}"
                if f not in fallbacks:
                    fallbacks.append(f)
    mc = tr["cost"]
    roof = RL.analyze_module_cost(mc, H100)
    f64 = RL.check_no_f64(mc)
    mflops, formula = RL.model_flops(cfg, shape, chips)
    flops_global = roof.flops_per_dev * chips
    out_b = tr["out_bytes"]
    tmp_b = max(tr["peak_bytes"] - out_b, 0)
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] traced in "
              f"{tr['trace_s']:.1f} s: {mc.ops} ops, "
              f"{mc.flops:.4g} FLOP/dev")
    result.update(
        chips=chips, trace_s=round(tr["trace_s"], 2),
        torch=torch.__version__, hardware=H100.name,
        params=api.param_count(cfg),
        params_active=cfg.param_count(active_only=True),
        arg_bytes_per_dev=arg_b, temp_bytes_per_dev=tmp_b,
        out_bytes_per_dev=out_b,
        hbm_fit=bool(arg_b + tmp_b + out_b <= H100.hbm_bytes),
        roofline=roof.to_dict(),
        model_flops=mflops, model_flops_formula=formula,
        useful_ratio=(mflops / flops_global if flops_global else 0.0),
        fallbacks=fallbacks,
        f64_leaks=f64[:5],
        top_flops=mc.top_flops(),
        top_wire=mc.top_wire(),
        kernels=tr["kernels"],
        ops=mc.ops,
    )
    if f64:
        result["status"] = "f64-leak"
    return result


def art_path(arch, shape, mesh_name, art_dir=ART_DIR):
    return os.path.join(art_dir, f"{arch}__{shape}__{mesh_name}.json")


# sweep order: cheapest to trace first, so the artifact dir fills with
# signal early and the trillion-parameter cells run last
SWEEP_ORDER = (
    "mamba2-130m", "whisper-medium", "internvl2-2b", "olmoe-1b-7b",
    "qwen1.5-32b", "deepseek-coder-33b", "command-r-35b",
    "command-r-plus-104b", "jamba-1.5-large-398b", "kimi-k2-1t-a32b",
)


def cells():
    for arch in SWEEP_ORDER:
        for shape in SHAPES:
            for mesh_name in ("single", "multi"):
                yield arch, shape, mesh_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="",
                    help="variant tag for tagged artifacts")
    ap.add_argument("--rules", default=None,
                    help='JSON rule overrides, e.g. {"seq": "model"}')
    ap.add_argument("--cfg", default=None,
                    help='JSON ModelConfig overrides, e.g. '
                         '{"ssm_chunk": 128}')
    ap.add_argument("--report", action="store_true",
                    help="print the artifacts as JSON")
    ap.add_argument("--device", default="cuda",
                    help="the device the mesh and the traced cell are for "
                         "(cuda; the tests pass cpu)")
    ap.add_argument("--out", default=ART_DIR,
                    help="the artifact directory")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.report:
        rows = []
        for arch, shape, mesh_name in cells():
            p = art_path(arch, shape, mesh_name, args.out)
            if os.path.exists(p):
                with open(p) as fh:
                    rows.append(json.load(fh))
        print(json.dumps(rows, indent=1))
        return 0

    if args.all:
        # each cell in a fresh interpreter: a process group is
        # process-wide, and memory is given back
        import subprocess
        failures = []
        for arch, shape, mesh_name in cells():
            p = art_path(arch, shape, mesh_name, args.out)
            if os.path.exists(p) and not args.force:
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_name,
                   "--device", args.device, "--out", args.out]
            print(">>", " ".join(cmd), flush=True)
            r = subprocess.run(cmd)
            if r.returncode != 0:
                failures.append((arch, shape, mesh_name))
        print("failures:", failures)
        return 1 if failures else 0

    mesh_name = args.mesh + (f"@{args.tag}" if args.tag else "")
    path = art_path(args.arch, args.shape, mesh_name, args.out)
    try:
        res = run_cell(args.arch, args.shape, args.mesh == "multi",
                       tag=args.tag,
                       rule_overrides=json.loads(args.rules)
                       if args.rules else None,
                       cfg_overrides=json.loads(args.cfg)
                       if args.cfg else None, device=args.device)
    except Exception:
        res = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
               "status": "fail", "error": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    if res["status"] == "fail":
        print(res["error"])
        return 1
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("roofline",)}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
