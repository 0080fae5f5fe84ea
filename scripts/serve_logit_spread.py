"""How far the card's logits of the serving model lie from the CPU's, when
the card is right and when it carries a planted fault: the basis of the
card-vs-CPU tolerances of chip_smoke.py's phase 8 and of the bf16 case of
tests/test_torch_cuda.py::test_two_layer_serve_on_card_matches_cpu.

    python3 scripts/serve_logit_spread.py [--trials 3] [--out DIR]

Needs a CUDA device (and ~11 GB of host memory for the CPU's copy of the
weights).  Two configurations:

  serve  chip_smoke.py's phase 8: deepseek-coder-33b at full width, 4 of
         62 layers, bf16 parameters from SERVE_SEED, and its cross-check
         (CHECK_PROMPTS teacher-forced on the CPU for CHECK_STEPS decode
         steps): max|d|/std, rms(d)/std and greedy gap/std per step.
         Trial 0 draws phase 8's own prompts, later trials other seeds;
  test   the test's bf16 case: the smoke deepseek-coder-33b (2 layers,
         head_dim 64), rms(d)/std of a full-sequence apply over the
         test's three prompts.  Trial i draws the parameters from seed i
         (trial 0 is the test's).

Each runs twice on the card: as it is (sound), and with the query heads
handed to the flash kernel in the wrong GQA order (head h = g * Kv + kv
instead of kv * G + g; fault).  The CPU runs the plain version.  A check
fails when any of a run's readings passes its limit, so per metric this
prints the worst sound reading over all trials and, for the fault, the
least over trials of each trial's largest reading.  A limit between the
two passes every sound run measured and catches every faulty one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

METRICS = ("max", "rms", "greedy_gap")
TEST_PROMPT_LENS, TEST_PROMPT_SEED = (8, 19, 33), 5


@contextlib.contextmanager
def planted(fault: bool):
    """With ``fault``, the card's flash attention gets its query heads in
    the wrong GQA order; the CPU's plain version is left alone."""
    orig = fa_ops.flash_attention

    def wrong_head_order(q, k, v, causal=True):
        if q.is_cuda:
            b, s, h, d = q.shape
            kv = k.shape[2]
            q = q.reshape(b, s, h // kv, kv, d).transpose(2, 3).reshape(
                b, s, h, d)
        return orig(q, k, v, causal)
    if fault:
        fa_ops.flash_attention = wrong_head_order
    try:
        yield
    finally:
        fa_ops.flash_attention = orig


def summarize(runs, metrics):
    """runs: {"sound"/"fault": [[row, ...] per trial]} -> the worst sound
    reading and the least of the faulty trials' largest readings."""
    out = {}
    for m in metrics:
        out[m] = {
            "sound_worst": max(r[m] for trial in runs["sound"]
                               for r in trial),
            "fault_least": min(max(r[m] for r in trial)
                               for trial in runs["fault"])}
    return out


def serve_config(dev, trials):
    cfg = get_config(cs.SERVE_ARCH).replace(num_layers=cs.SERVE_LAYERS)
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(cs.SERVE_SEED))
    cpu_params = tree_map(lambda x: x.cpu(), params)
    runs = {"sound": [], "fault": []}
    for kind in runs:
        for trial in range(trials):
            t0 = time.perf_counter()
            with planted(kind == "fault"):
                rows = cs.cross_check_readings(
                    cfg, params, cpu_params, dev, cs.CHECK_PROMPTS,
                    cs.SERVE_SEED + 2 + 100 * trial)
            runs[kind].append(rows)
            worst = {m: round(max(r[m] for r in rows), 4) for m in METRICS}
            print(f"serve {kind} trial {trial} (prompts {cs.CHECK_PROMPTS}):"
                  f" largest {worst}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    del params, cpu_params
    return runs, summarize(runs, METRICS)


def test_config(dev, trials):
    cfg = smoke_config("deepseek-coder-33b").replace(dtype="bfloat16",
                                                     head_dim=64)
    rng = np.random.default_rng(TEST_PROMPT_SEED)
    prompts = [rng.integers(16, cfg.vocab_size, n).tolist()
               for n in TEST_PROMPT_LENS]
    runs = {"sound": [], "fault": []}
    for trial in range(trials):
        params = api.init_params(
            cfg, torch.Generator(device=dev).manual_seed(trial))
        cpu_params = tree_map(lambda x: x.cpu(), params)
        for kind in runs:
            rows = []
            for prompt in prompts:
                tok = torch.tensor([prompt], dtype=torch.int32)
                with planted(kind == "fault"):
                    got, _ = api.apply(cfg, params, {"tokens": tok.to(dev)})
                want, _ = api.apply(cfg, cpu_params, {"tokens": tok})
                d = got.float().cpu() - want.float()
                rows.append({"prompt": len(prompt),
                             "rms": float(d.pow(2).mean().sqrt()
                                          / want.float().std())})
            runs[kind].append(rows)
            print(f"test {kind} trial {trial}: rms/std "
                  f"{[round(r['rms'], 4) for r in rows]}", flush=True)
    return runs, summarize(runs, ("rms",))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="directory for serve_logit_spread.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_logit_spread: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)} | "
          f"{cs.nvidia_smi_line()}", flush=True)
    res = {}
    for name, fn in (("test", test_config), ("serve", serve_config)):
        runs, summary = fn(dev, args.trials)
        res[name] = {"runs": runs, "summary": summary}
        for m, v in summary.items():
            print(f"{name} {m}/std: worst sound {v['sound_worst']:.4f}, "
                  f"least fault {v['fault_least']:.4f}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "serve_logit_spread.json"),
                  "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
