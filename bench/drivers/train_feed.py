"""Training fed by the IDEA data plane: the port's ``Trainer`` over packed
batches that the port's ``train/data_feed.py::FeedDataSource`` makes from
a stream of tweets, at its own depths (8 frames a partition holder, 8
packed batches ready): parse, UDF2 (the SensitiveWords join), the LM
tokenizer, the safe-only filter, and a tee whose sink packs the enriched
records with the port's ``StreamPacker``.

``FeedDataSource`` makes its own adapter, so while it is built its
module's ``pipeline`` is one that puts the benchmark's frozen stream in
that adapter's place and notes the record ids of each enriched batch in
the order the port's sink takes them, which the reference needs and
cannot know.

Set-up draws the weights, starts the feed and runs the first three steps
through ``Trainer.run``, the window's own call: the reference follows
them.  The window then trains on for ``--seconds``; a traced run
profiles a few steps in its middle.

Traffic keys: ``rows``, ``seq``, ``frame_size``, ``frames`` (the
stream's length: more than set-up and the window take),
``partitions``, ``safety_filter``, ``trace_steps``.
"""

from __future__ import annotations

import statistics
import sys
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

from bench.data import tweets
from bench.harness import portcfg, weights
from bench.harness.seeds import stream_seed
from bench.harness.stages import Stages
from bench.harness.trace import Tracer

CHECKED_STEPS = 3
FIRST_TRACED_STEP = 2      # window steps before the traced ones


def frozen_adapter(frames: List[List[bytes]]):
    """An adapter of the port's feed that delivers ``frames`` (made in
    set-up, so that generating them loads no host thread in the window:
    a deployment's adapter reads bytes that arrive)."""
    from repro_torch.core import Adapter

    class FrozenTweets(Adapter):
        def frames(self):
            for frame in frames:
                if self._stop.is_set():
                    return
                self.offset += len(frame)
                yield frame

    return FrozenTweets()


def feed_data_source(manager, frames: List[List[bytes]], vocab: int,
                     tr: Dict, name_seed: int) -> Tuple[object, List]:
    """The port's ``FeedDataSource`` over ``frames``, and the list that
    receives the record ids of each enriched batch as its sink takes it.

    The noting sink holds a lock of its own around the port's sink, so the
    ids are noted in the order the port's sink packs them (its own lock
    then never waits)."""
    from repro_torch.train import data_feed
    arrivals: List[np.ndarray] = []
    lock = threading.Lock()
    port_pipeline = data_feed.pipeline

    def pipeline(_adapter, name):
        p = port_pipeline(frozen_adapter(frames), name)
        tee = p.tee

        def noting_tee(sink, name=None):
            def noted(batch):
                with lock:
                    arrivals.append(np.array(batch["id"]))
                    sink(batch)
            return tee(noted, name=name)

        p.tee = noting_tee
        return p

    data_feed.pipeline = pipeline
    try:
        source = data_feed.FeedDataSource(
            manager, vocab, int(tr["seq"]), int(tr["rows"]),
            total_records=sum(len(f) for f in frames),
            frame_size=int(tr["frame_size"]),
            safety_filter=bool(tr["safety_filter"]),
            num_partitions=int(tr["partitions"]), seed=name_seed)
    finally:
        data_feed.pipeline = port_pipeline
    return source, arrivals


def _leaves(tree) -> List:
    """Leaves in sorted-key order (the port's and the reference's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def leaf_names(tree, prefix: str = "") -> List[str]:
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _norms(tensors) -> List[float]:
    import torch
    return [float(torch.linalg.vector_norm(t.float())) for t in tensors]


def sensitive_store(seed: int):
    """The port's reference store holding the benchmark's SensitiveWords
    (with the headroom the port's generator leaves for upserts)."""
    from repro_torch.core import RefStore
    rows = tweets.sensitive_words(stream_seed(seed, "tables"))
    store = RefStore()
    t = store.create("sensitive_words", len(rows["key"]) + 1024,
                     {"country": np.int32, "word": np.int64})
    t.upsert(rows["key"], country=rows["country"], word=rows["word"])
    return store, rows


def optimizer(cf: Dict) -> Dict:
    return dict(cf["train"]["optimizer"])


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict:
    import torch
    from repro_torch.core import FeedManager
    from repro_torch.train import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cf, tr = cell.config, cell.traffic
    cfg = portcfg.model_config(cf)
    if device.type == "cuda":
        # float32 products in TF32, as repro_torch.launch.train sets them
        torch.backends.cuda.matmul.allow_tf32 = True
    frame = int(tr["frame_size"])
    total = frame * int(tr["frames"])

    stages = Stages(t_start, device)
    store, table = sensitive_store(seed)
    manager = FeedManager(store, device=device)
    trainer = Trainer(cfg, OptConfig(**optimizer(cf)),
                      TrainerConfig(steps=1, log_every=1,
                                    seed=stream_seed(seed, "trainer")),
                      device=device)
    trainer.state["params"] = None
    trainer.state["params"] = weights.draw(cfg, seed, device)
    stages.mark("imports, CUDA context, tables, trainer and weights")
    frames = list(tweets.TweetStream(stream_seed(seed, "records"),
                                     frame).frames(total))
    source, arrivals = feed_data_source(manager, frames, cfg.vocab_size,
                                        tr, seed)
    record: Dict = {"stream_seed": stream_seed(seed, "records"),
                    "table": table, "frame_size": frame, "total": total}
    # the port's close() waits for an end that an ended stream has
    # already delivered, so an ended feed is not closed
    ended: List[bool] = []

    def batches():
        yield from source
        ended.append(True)

    try:
        it = batches()
        checked: List[Dict] = []

        def first_batches():
            for b in it:
                if not checked:
                    stages.mark("feed start and first batch")
                checked.append({k: np.array(v) for k, v in b.items()})
                yield b

        setup = first_batches()
        trainer.run(setup)                       # step 1
        stages.mark("step 1")
        b1 = trainer.opt_cfg.b1
        grad_norms = [n / (1 - b1) for n in
                      _norms(_leaves(trainer.state["opt"]["m"]))]
        trainer.tcfg.steps = CHECKED_STEPS
        trainer.run(setup)                       # steps 2 and 3
        drawn = _leaves(weights.draw(cfg, seed, device))
        change = _norms(p.float() - p0.float() for p, p0 in
                        zip(_leaves(trainer.state["params"]), drawn))
        del drawn
        stages.mark("steps 2 and 3, and the checked readings")
        losses = [h["loss"] for h in trainer.history]
        loss_tokens = [h["tokens"] for h in trainer.history]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start

        # ------------------------------------------------------- window
        trainer.tcfg.steps = 1 << 62
        trainer.tcfg.log_every = TrainerConfig.log_every
        n0 = len(trainer.step_times)
        tracer = Tracer(device) if trace else None
        n_trace = int(tr["trace_steps"])
        taken: List[Dict] = []     # the window's batches
        ready: List[int] = []      # batches the feed held ready at each ask
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def window():
            # nothing here but the trace's start and stop, so that the
            # trainer's data wait is the feed's; the two steps whose wait
            # holds a start or a stop are left out of the step means
            while True:
                ready.append(source._q.qsize())
                b = next(it, None)
                k = len(taken)
                if tracer is not None and k == FIRST_TRACED_STEP + n_trace:
                    tracer.stop()
                if b is None or time.perf_counter() >= deadline:
                    return
                if tracer is not None and k == FIRST_TRACED_STEP:
                    tracer.start()
                taken.append(b)
                yield b

        trainer.run(window())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        ran_dry = time.perf_counter() < deadline
        if tracer is not None:
            tracer.stop()
            window_s -= tracer.overhead_s
            tracer.finish()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        times = trainer.step_times[n0:]
        print(f"feed: packed batches ready at each of the window's asks "
              f"{ready}", file=sys.stderr)
        record.update({
            "setup_s": setup_s, "window_s": window_s,
            "steps": len(times),
            "tokens": sum(float(b["loss_mask"].sum()) for b in taken),
            "segment_lengths": [n for b in taken
                                for n in _segment_lengths(b["segment_ids"])],
            "step_times": times,
            "tracer_steps": ([FIRST_TRACED_STEP, FIRST_TRACED_STEP + n_trace]
                             if tracer is not None else []),
            "memory_peak_bytes": peak, "ran_dry": ran_dry,
            "trace": tracer.summary if tracer is not None else None,
            "checked_batches": checked[:CHECKED_STEPS],
            "losses": losses[:CHECKED_STEPS],
            "loss_tokens": loss_tokens[:CHECKED_STEPS],
            "grad_norms": grad_norms, "changes": change,
            "leaf_names": leaf_names(trainer.state["params"]),
            "leaf_dtypes": [str(p.dtype).removeprefix("torch.") for p in
                            _leaves(trainer.state["params"])],
            "finite": bool(np.isfinite([h["loss"] for h in
                                        trainer.history]).all()),
            "config": cf, "traffic": tr, "seed": seed,
        })
    finally:
        if not ended:
            source.close()
        trainer.state = None
    record["arrivals"] = list(arrivals)
    record["attempted"] = record.get("steps", 0)
    # a step whose loss is not finite, or a stream that ran dry before
    # the window closed, fails the run
    record["failed"] = int(not record.get("finite", False)
                           or record.get("ran_dry", True))
    return record


def _segment_lengths(seg: np.ndarray) -> List[int]:
    """Lengths of the documents (segment ids > 0) of a packed batch."""
    out = []
    for row in np.asarray(seg):
        ids, counts = np.unique(row[row > 0], return_counts=True)
        out.extend(int(c) for c in counts)
    return out


def check(run: Dict, device, precision: str = "float32") -> Dict[str, float]:
    """The numbers ``correct`` compares (``reference/training.py`` names
    them).  With ``precision`` other than float32, the reference in that
    precision takes the program's place: the control."""
    import torch
    from bench.reference import data_plane, model, training
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cf = run["config"]
    cfg = portcfg.model_config(cf)
    got_batches = run["checked_batches"]
    ref_batches = training.reference_batches(run, CHECKED_STEPS)
    mism = sum(data_plane.mismatches(p, r)
               for p, r in zip(got_batches, ref_batches))
    # a batch one side lacks differs at every position
    mism += abs(len(ref_batches) - len(got_batches)) * int(
        run["traffic"]["rows"]) * int(run["traffic"]["seq"])

    def fresh():
        return weights.as_float32(weights.draw(cfg, run["seed"], device))

    opt = optimizer(cf)
    if "_reference" not in run:      # kept for a second (control) call
        model.ROUTED.update(kept=0, all=0)
        run["_reference"] = training.train_steps(cf, fresh, ref_batches,
                                                 opt, "float32", device)
        if model.ROUTED["all"]:
            print(f"reference: routed pairs within capacity "
                  f"{model.ROUTED['kept']} of {model.ROUTED['all']}",
                  file=sys.stderr)
    ref = run["_reference"]
    got = {k: run[k] for k in ("losses", "grad_norms", "changes")}
    if precision != "float32":
        got = training.train_steps(cf, fresh, ref_batches, opt, precision,
                                   device, run["leaf_dtypes"])
    keep = [g >= training.NEGLIGIBLE * statistics.median(ref["grad_norms"])
            for g in ref["grad_norms"]]
    names = run["leaf_names"]
    print(f"reference: losses {ref['losses']} against {got['losses']}",
          file=sys.stderr)
    for what in ("grad_norms", "changes"):
        gaps = [abs(g - w) / w if w else 0.0 for g, w, k in
                zip(got[what], ref[what], keep) if k]
        worst = max(range(len(gaps)), key=gaps.__getitem__)
        kept = [n for n, k in zip(names, keep) if k]
        print(f"reference: {what} worst leaf {kept[worst]} "
              f"({got[what][names.index(kept[worst])]!r} against "
              f"{ref[what][names.index(kept[worst])]!r}); left out "
              f"{[n for n, k in zip(names, keep) if not k]}",
              file=sys.stderr)
    steps = len(ref["losses"])
    loss_gap = (max(abs(a - b) / b for a, b in zip(got["losses"],
                                                   ref["losses"]))
                if len(got["losses"]) == steps else float("inf"))
    want_tokens = [float(np.asarray(b["loss_mask"]).sum())
                   for b in ref_batches]
    tokens_gap = (max(abs(a - b) for a, b in zip(run["loss_tokens"],
                                                 want_tokens))
                  if len(run["loss_tokens"]) == steps else float("inf"))
    return {"batch_mismatch": float(mism), "loss_tokens_gap": tokens_gap,
            "loss_gap": loss_gap,
            "grad_norm_gap": training.worst_gap(got["grad_norms"],
                                                ref["grad_norms"], keep),
            "update_gap": training.worst_gap(got["changes"],
                                             ref["changes"], keep)}
