"""How far the card's logits of chip_smoke.py's phases 10-13 lie from the
CPU's, when the card is right and when it carries a planted fault: the
basis of FAMILY_TOL and SSM_CONTINUE_TOL in chip_smoke.py.

    python3 scripts/family_serve_spread.py [--trials 3]
        [--families moe,ssm,vlm,encdec] [--out DIR]

Needs a CUDA device (and ~10 GB of host memory for the CPU's copies).
Per family, the phase's model whole on the card (seeded as the phase
seeds it) and its cross-check config (FAMILY_SERVE: olmoe-1b-7b and
internvl2-2b cut to 2 layers, whisper-medium to 2 encoder and 2 decoder
layers over seeded random frames, mamba2-130m whole), read by
``chip_smoke.cross_check_readings`` (max|d|/std, rms(d)/std and greedy
gap/std per prompt and step, the CPU teacher-forced with the card's
tokens).  Trial 0 draws the phase's own prompts, later trials other
seeds.  Each trial runs sound and with each of two faults planted on the
card only (the CPU runs the plain port):

  moe  renorm     the top-k gates not renormalised (softmax over all
                  experts, read at the chosen ones);
       overflow   an expert over capacity keeps its last tokens instead
                  of its first (the grouping sort's tie order reversed);
  ssm  chunkstate the SSD state not carried from chunk to chunk;
       convcache  prefill hands decode zero conv tails;
  vlm  heads      the query heads handed to the flash kernel in the wrong
                  GQA order (as scripts/serve_logit_spread.py);
       len        the cache's len without the frontend's rows;
  encdec enccausal the encoder's self-attention causal (the ``causal=False``
                  of repro's encoder lost);
       xkv        a decode step's cross-attention reading the cached
                  encoder keys as its values.

For phase 11 it also reads the float32 continuation check
(``chip_smoke.ssm_continuation``), sound and with each ssm fault.  A
check fails when any of a run's readings passes its limit, so per metric
this prints the worst sound reading over all trials and, per fault, the
least over trials of each trial's largest reading.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

METRICS = ("max", "rms", "greedy_gap")
FAULTS = {"moe": ("renorm", "overflow"), "ssm": ("chunkstate", "convcache"),
          "vlm": ("heads", "len"), "encdec": ("enccausal", "xkv")}


def on_card(x) -> bool:
    """Where a fault applies: tensors on the card."""
    return x.is_cuda


def _renorm(orig):
    def route(logits, k):
        w, idx = orig(logits, k)
        if on_card(logits):
            w = torch.gather(torch.softmax(logits, dim=-1), -1, idx)
        return w, idx
    return route


def _overflow(orig):
    def slots(idx, e, cap):
        if not on_card(idx):
            return orig(idx, e, cap)
        t, k = idx.shape[1], idx.shape[2]
        order, keep, slot = orig(idx.flip(1), e, cap)
        return (t - 1 - order // k) * k + order % k, keep, slot
    return slots


def _chunkstate(orig):
    def ssd(cfg, xh, dt, b, c, a_log, init_state=None):
        q = min(cfg.ssm_chunk, xh.shape[1])
        if not on_card(xh) or xh.shape[1] == q:
            return orig(cfg, xh, dt, b, c, a_log, init_state)
        ys = []
        for i in range(0, xh.shape[1], q):
            y, state = orig(cfg, xh[:, i:i + q], dt[:, i:i + q],
                            b[:, i:i + q], c[:, i:i + q], a_log)
            ys.append(y)
        return torch.cat(ys, dim=1), state
    return ssd


def _convcache(orig):
    def block(cfg, p, x, return_cache=False):
        out = orig(cfg, p, x, return_cache)
        if not (return_cache and on_card(x)):
            return out
        y, cache = out
        return y, {k: torch.zeros_like(v) if k.startswith("conv") else v
                   for k, v in cache.items()}
    return block


def _heads(orig):
    def attention(q, k, v, causal=True):
        if on_card(q):
            b, s, h, d = q.shape
            kv = k.shape[2]
            q = q.reshape(b, s, h // kv, kv, d).transpose(2, 3).reshape(
                b, s, h, d)
        return orig(q, k, v, causal)
    return attention


def _len(orig):
    def prefill(cfg, params, tokens, frontend=None):
        cache, logits = orig(cfg, params, tokens, frontend)
        if on_card(tokens):
            cache["len"] = cache["len"] - cfg.num_frontend_tokens
        return cache, logits
    return prefill


def _enccausal(orig):
    def attention(q, k, v, causal=True):
        # the encoder's is the only non-causal attention with S = T (the
        # cross-attention's S is a prompt of at most 448 rows, T 1,536)
        if on_card(q) and not causal and q.shape[1] == k.shape[1]:
            causal = True
        return orig(q, k, v, causal)
    return attention


def _xkv(orig):
    def apply(cfg, p, q, k, v):
        if on_card(q) and q.shape[1] == 1:
            v = k
        return orig(cfg, p, q, k, v)
    return apply


PLANTS = {"renorm": (M, "_route", _renorm),
          "overflow": (M, "expert_slots", _overflow),
          "chunkstate": (S, "ssd_chunked", _chunkstate),
          "convcache": (S, "ssm_block", _convcache),
          "heads": (fa_ops, "flash_attention", _heads),
          "len": (T, "prefill", _len),
          "enccausal": (fa_ops, "flash_attention", _enccausal),
          "xkv": (L, "cross_attention_apply", _xkv)}


@contextlib.contextmanager
def planted(fault):
    """The named fault patched into the port, on the card only; None
    plants nothing."""
    if fault is None:
        yield
        return
    mod, name, wrap = PLANTS[fault]
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def summarize(runs, metrics):
    """runs: {"sound"/fault: [[row, ...] per trial]} -> per metric the
    worst sound reading and, per fault, the least of the trials' largest
    readings."""
    out = {}
    for m in metrics:
        out[m] = {"sound_worst": max(r[m] for trial in runs["sound"]
                                     for r in trial)}
        for kind, trials in runs.items():
            if kind != "sound":
                out[m][f"{kind}_least"] = min(max(r[m] for r in trial)
                                              for trial in trials)
    return out


def family(fam, dev, trials):
    from repro_torch.models.params import torch_dtype
    cfg, params, _ = cs.family_model(fam, dev)
    spec = cs.FAMILY_SERVE[fam]
    ccfg, cparams = cs.depth_cut(cfg, params, spec["check_layers"])
    cpu_params = cs.cpu_copy(cparams, torch_dtype(cfg.dtype))
    runs = {kind: [] for kind in ("sound",) + FAULTS[fam]}
    cont = {}
    for kind in runs:
        fault = None if kind == "sound" else kind
        for trial in range(trials):
            t0 = time.perf_counter()
            with planted(fault):
                rows = cs.cross_check_readings(
                    ccfg, cparams, cpu_params, dev, spec["check_prompts"],
                    cs.SERVE_SEED + 2 + 100 * trial)
            runs[kind].append(rows)
            worst = {m: round(max(r[m] for r in rows), 4) for m in METRICS}
            print(f"{fam} {kind} trial {trial} (prompts "
                  f"{spec['check_prompts']}, {ccfg.num_layers} layers): "
                  f"largest {worst}; {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if fam == "ssm":
            with planted(fault):
                cont[kind] = cs.ssm_continuation(cfg, params, dev)
            print(f"ssm {kind} continuation max|d|/std {cont[kind]:.4g}",
                  flush=True)
    del params, cparams, cpu_params
    gc.collect()
    torch.cuda.empty_cache()
    res = {"runs": runs, "summary": summarize(runs, METRICS)}
    if cont:
        res["continuation"] = cont
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--families", default="moe,ssm,vlm,encdec")
    ap.add_argument("--out", default=None,
                    help="directory for family_serve_spread.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("family_serve_spread: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)} | "
          f"{cs.nvidia_smi_line()}", flush=True)
    res = {}
    for fam in args.families.split(","):
        res[fam] = family(fam, dev, args.trials)
        for m, v in res[fam]["summary"].items():
            print(f"{fam} {m}/std: " + ", ".join(
                f"{k} {x:.4f}" for k, x in v.items()), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "family_serve_spread.json"),
                      "w") as fh:
                json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
