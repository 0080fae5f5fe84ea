"""Documents labelled by a served model: the port's ``ServingEngine``
driven through ``submit`` and ``step``, each document a prompt that the
engine prefills and then continues for a few tokens.

Arrivals are a closed loop of ``clients``: each hands over its next
document when its last one completes.  Prompt lengths are a fixed set of
sizes (``lengths``: strata of a log-uniform range), taken by every client
in rounds of the whole set, in one fixed order that alternates long and
short sizes; the clients start at evenly spaced points of it, so long
documents spread over them alike whatever the seed.  The seed draws the
token ids, over the vocabulary above its reserved ids.

Set-up draws the weights, builds the engine with room for the longest
prompt and its new tokens (``max_len``), and admits one
prompt of every size (every prefill shape of the window) before the
window opens.

Traffic keys: ``slots``, ``bucket``, ``new_tokens``, ``clients``,
``lengths`` ({"lo", "hi", "levels"}), ``check_docs``,
``trace_seconds``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterator, List, Tuple

from bench.harness import portcfg, weights
from bench.harness.seeds import rng
from bench.harness.stages import Stages
from bench.harness.trace import Tracer

RESERVED_IDS = 16          # pad, bos, eos and the tokenizer's specials


def prompt_lengths(tr: Dict) -> List[int]:
    """The set of prompt sizes: the midpoints of ``levels`` equal strata
    of log-uniform(lo, hi)."""
    lo, hi, n = (int(tr["lengths"][k]) for k in ("lo", "hi", "levels"))
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


def schedule(tr: Dict, client: int) -> Iterator[int]:
    """Client ``client``'s prompt sizes: rounds of the whole set, in the
    order of the golden-ratio sequence (consecutive sizes lie far apart),
    started at the client's own evenly spaced offset."""
    sizes = prompt_lengths(tr)
    n = len(sizes)
    order = sorted(range(n), key=lambda i: (i * 0.6180339887498949) % 1.0)
    at = client * n // int(tr["clients"])
    while True:
        yield sizes[order[at % n]]
        at += 1


def prompt(seed: int, stream: str, k: int, n: int, vocab: int) -> List[int]:
    return rng(seed, f"prompt/{stream}/{k}").integers(
        RESERVED_IDS, vocab, n).tolist()


def max_len(tr: Dict) -> int:
    """The engine's cache length: the longest prompt, its new tokens and
    the one slot the engine keeps free (it ends a request once prompt and
    tokens reach ``max_len - 1``), rounded up to the bucket."""
    b = int(tr["bucket"])
    n = max(prompt_lengths(tr)) + int(tr["new_tokens"]) + 1
    return -(-n // b) * b


class Arrivals:
    """The closed loop's documents as they fall due: ``take(now)`` returns
    those due by ``now``; a client's next is due when ``done`` hands back
    its last."""

    def __init__(self, tr: Dict, t0: float):
        self.due: List[Tuple[float, str, int, int]] = []  # at, stream, k, n
        self._sched = {f"client{c}": schedule(tr, c)
                       for c in range(int(tr["clients"]))}
        self._counts = dict.fromkeys(self._sched, 0)
        for stream in self._sched:
            self.done(stream, t0)

    def take(self, now: float) -> List[Tuple[float, str, int, int]]:
        out = [d for d in self.due if d[0] <= now]
        self.due = [d for d in self.due if d[0] > now]
        return out

    def done(self, stream: str, now: float) -> None:
        k = self._counts[stream]
        self._counts[stream] = k + 1
        self.due.append((now, stream, k, next(self._sched[stream])))


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict:
    import torch
    from repro_torch.serve import Request, ServingEngine
    cf, tr = cell.config, cell.traffic
    cfg = portcfg.model_config(cf)
    new = int(tr["new_tokens"])
    params = weights.draw(cfg, seed, device)
    stages = Stages(t_start, device)
    stages.mark("imports, CUDA context and weights")
    eng = ServingEngine(cfg, params, slots=int(tr["slots"]),
                        max_len=max_len(tr), prompt_bucket=int(tr["bucket"]),
                        device=device)
    for i, n in enumerate(prompt_lengths(tr)):      # every prefill shape
        eng.submit(Request(prompt(seed, "warm", i, n, cfg.vocab_size),
                           max_new_tokens=2, stop_at_eos=False))
    eng.run()
    stages.mark("engine and one admission of every prompt size")
    eng.prefills = eng.decode_steps = 0
    eng.prefill_s = eng.decode_s = 0.0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(device) if trace else None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_at = t0 + (seconds - float(tr["trace_seconds"])) / 2
    trace_end = trace_at + float(tr["trace_seconds"])
    arrivals = Arrivals(tr, t0)
    live: Dict[int, Dict] = {}
    done: List[Dict] = []
    traced_prompts: List[int] = []
    tracing = False
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if tracer is not None:
            if not tracing and trace_at <= now < trace_end:
                tracer.start()
                tracing = True
            elif tracing and now >= trace_end:
                tracer.stop()
                tracing = False
        for due, stream, k, n in arrivals.take(now):
            req = eng.submit(Request(prompt(seed, stream, k, n,
                                            cfg.vocab_size),
                                     max_new_tokens=new, stop_at_eos=False))
            live[req.rid] = {"req": req, "due": due, "stream": stream,
                             "admitted": False}
        eng.step()
        end = time.perf_counter()
        for doc in live.values():
            if not doc["admitted"] and doc["req"].tokens:
                doc["admitted"] = True
                if tracing:
                    traced_prompts.append(len(doc["req"].prompt))
        for req in eng.completed:
            doc = live.pop(req.rid)
            doc["latency_s"] = end - doc["due"]
            done.append(doc)
            arrivals.done(doc["stream"], end)
        eng.completed.clear()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    if tracing:
        tracer.stop()
    if tracer is not None:
        window_s -= tracer.overhead_s
        tracer.finish()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = [d for d in done if len(d["req"].tokens) != new or not all(
        0 <= t < cfg.vocab_size for t in d["req"].tokens)]
    record = {
        "setup_s": setup_s, "window_s": window_s,
        "docs": [{"prompt": d["req"].prompt, "tokens": list(d["req"].tokens),
                  "latency_s": d["latency_s"]} for d in done],
        "prefill_s": eng.prefill_s, "prefills": eng.prefills,
        "decode_s": eng.decode_s, "decode_steps": eng.decode_steps,
        "memory_peak_bytes": peak,
        "trace": tracer.summary if tracer is not None else None,
        "traced_prompts": traced_prompts,
        "attempted": len(done), "failed": len(failed),
        "config": cf, "traffic": tr, "seed": seed,
    }
    del eng, params
    return record


def check(run: Dict, device, precision: str = "float32") -> Dict[str, float]:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position, over a sample of the finished
    documents drawn from the seed (the longest among them).  With
    ``precision`` other than float32 the tokens judged are the ones that
    precision puts first (the control)."""
    import torch
    from bench.reference import model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    docs = run["docs"]
    if not docs:
        return {"served_logit_gap": math.inf}
    want = min(int(run["traffic"]["check_docs"]), len(docs))
    longest = max(range(len(docs)), key=lambda i: len(docs[i]["prompt"]))
    others = [i for i in range(len(docs)) if i != longest]
    pick = [longest] + rng(run["seed"], "check").choice(
        others, want - 1, replace=False).tolist()
    cfg = portcfg.model_config(run["config"])
    w = weights.as_float32(weights.draw(cfg, run["seed"], device))
    dm = model.Dims(run["config"])
    worst = 0.0
    refs = run.setdefault("_reference", {})   # kept for a control call
    for i in pick:
        p, toks = docs[i]["prompt"], docs[i]["tokens"]
        at = list(range(len(p) - 1, len(p) - 1 + len(toks)))
        seq = p + toks[:-1]
        if i not in refs:
            refs[i] = model.sequence_logits(dm, w, seq, at, "float32",
                                            device)
        ref = refs[i]
        chosen = torch.tensor(toks, device=device)
        if precision != "float32":
            chosen = model.sequence_logits(dm, w, seq, at, precision,
                                           device).argmax(-1)
        gap = ref.max(-1).values - ref.gather(1, chosen[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return {"served_logit_gap": worst}
