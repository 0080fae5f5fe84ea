"""A copy of the benchmark at a size the CPU runs in seconds: the same
drivers, readers and reference, configurations of a few thousand
weights, short traffic, and a ``BENCHMARK.json`` naming its cells."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

DENSE = {
    "name": "tiny-dense", "source": "a test configuration",
    "port_arch": "deepseek-coder-33b", "hidden_size": 64,
    "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 512,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "compute": {"param_dtype": "float32", "activation_dtype": "float32",
                "peak_flops_per_s": 1e12},
    "train": {"optimizer": {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                            "weight_decay": 0.1, "grad_clip": 1.0,
                            "warmup_steps": 2, "total_steps": 1000,
                            "min_lr_ratio": 0.1, "state_dtype": "float32"}},
}
MOE = dict(DENSE, name="tiny-moe", port_arch="olmoe-1b-7b",
           intermediate_size=32, num_experts=8, num_experts_per_tok=2,
           num_key_value_heads=4, capacity_factor=1.25,
           norm_topk_prob=True)

SERVE = {"driver": "serve_loop", "slots": 2, "bucket": 16, "new_tokens": 4,
         "clients": 2, "lengths": {"lo": 20, "hi": 80, "levels": 4},
         "check_docs": 4, "trace_seconds": 0.3}
FEED = {"driver": "train_feed", "rows": 2, "seq": 256, "frame_size": 200,
        "frames": 40, "partitions": 2, "safety_filter": True,
        "trace_steps": 2}

# float32 on the CPU against the float32 reference: rounding alone
LIMITS = {
    "serve": {"served_logit_gap": 1e-3},
    "train": {"batch_mismatch": 0, "loss_tokens_gap": 0, "loss_gap": 1e-4,
              "grad_norm_gap": 1e-2, "update_gap": 1e-2},
}


def metric(name, unit, moves, cells, layer="x"):
    return {"name": name, "unit": unit, "better": "higher",
            "source": "host_clock", "layer": layer, "moves": moves,
            "workloads": cells}


def make(root: Path) -> Path:
    """Write the tiny benchmark under ``root``; returns ``root``."""
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "_build", "__pycache__", "tests"))
    for cf in (DENSE, MOE):
        (bench / "configs" / f"{cf['name']}.json").write_text(json.dumps(cf))
    (bench / "traffic" / "tiny_serve.json").write_text(json.dumps(SERVE))
    (bench / "traffic" / "tiny_feed.json").write_text(json.dumps(FEED))
    cells = {"enrich.tiny-dense.serve": ("tiny-dense", "tiny_serve", "serve"),
             "train.tiny-moe.feed": ("tiny-moe", "tiny_feed", "train"),
             "train.tiny-dense.feed": ("tiny-dense", "tiny_feed", "train")}
    for name, (_, _, kind) in cells.items():
        (bench / "limits" / f"{name}.json").write_text(
            json.dumps(LIMITS[kind]))
    serve = ["enrich.tiny-dense.serve"]
    train = ["train.tiny-moe.feed", "train.tiny-dense.feed"]
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": cf["name"], "source": cf["source"],
                        "file": f"bench/configs/{cf['name']}.json",
                        "reduced": [], "why": "test"}
                       for cf in (DENSE, MOE)]
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                          "why": "test"} for n, (c, t, _) in cells.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = serve if any(
                w.startswith("enrich") for w in m["workloads"]) else train
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
