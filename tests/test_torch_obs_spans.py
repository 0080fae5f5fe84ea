"""Program spans and counters of the port's model hot paths
(``repro_torch.core.obs.trace``): what a span costs and records with
tracing off and on, the request ids and parents the serving engine's
spans carry, the clock they share with ``torch.profiler``, one record
of each forward span and pair count whatever the rematerialisation, the
MoE pair counters against ``expert_slots``, and the trainer's
``step_times`` with and without a tracer.  CPU only, at smoke sizes."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import smoke_config
from repro_torch.core.obs import trace
from repro_torch.core.obs.trace import Tracer, span
from repro_torch.models import api
from repro_torch.models import moe as M
from repro_torch.serve import Request, ServingEngine
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CPU = torch.device("cpu")
MOE = "olmoe-1b-7b"
DENSE = "deepseek-coder-33b"
STEP_KEYS = {"data_wait_s", "grad_s", "update_s"}
TRACED_KEYS = STEP_KEYS | {"attn_fwd_s", "moe_route_fwd_s", "moe_pairs",
                           "moe_pairs_kept"}


def _batches(cfg, n, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        t = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
        yield {"tokens": t, "targets": np.roll(t, -1, 1)}


def _trained(cfg, tracer=None, steps=1):
    trainer = Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=1),
                      TrainerConfig(steps=steps, log_every=1),
                      device="cpu", tracer=tracer)
    trainer.run(_batches(cfg, steps))
    return trainer


class _Ranges:
    """Stands in for the profiler's function-scope range: counts opens."""
    opened = 0

    def __init__(self, name):
        type(self).opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def test_off_a_span_records_nothing_and_opens_no_profiler_range(
        monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Ranges)
    monkeypatch.setattr(_Ranges, "opened", 0)
    assert not torch.autograd._profiler_enabled()
    with span("model.attention") as s:
        assert s is None
    trace.count("moe.pairs_kept", torch.ones(3, dtype=torch.bool))
    # a whole MoE training step with no tracer: only the timed spans
    # measure, and nothing reaches a profiler range
    trainer = _trained(smoke_config(MOE))
    assert _Ranges.opened == 0
    assert set(trainer.step_times[0]) == STEP_KEYS


def test_nested_spans_carry_parents_attrs_and_the_request_id():
    tr = Tracer()
    with tr.active(CPU):
        with span("outer", rid=7, live=3):
            with span("inner"):
                with span("leaf", rid=8):
                    pass
        with span("other"):
            pass
    assert tr.drain() == []                 # nothing before settle()
    recs = {r["name"]: r for r in tr.settle()}
    assert recs["outer"]["parent"] is None and recs["outer"]["live"] == 3
    assert recs["inner"]["parent"] == recs["outer"]["id"]
    assert recs["inner"]["rid"] == 7        # inherited
    assert recs["leaf"]["parent"] == recs["inner"]["id"]
    assert recs["leaf"]["rid"] == 8
    assert recs["other"]["parent"] is None and "rid" not in recs["other"]
    o, i = recs["outer"], recs["inner"]
    assert o["t0"] <= i["t0"] and i["t0"] + i["dur"] <= o["t0"] + o["dur"]
    assert all(r["device_s"] > 0 for r in recs.values())
    assert len(tr.drain()) == 4


def test_serving_spans_share_a_request_id_and_the_queue_meets_admission():
    cfg = smoke_config(DENSE)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    tr = Tracer()
    eng = ServingEngine(cfg, params, slots=2, max_len=64, prompt_bucket=16,
                        device=CPU, tracer=tr)
    rng = np.random.default_rng(1)
    reqs = [eng.submit(Request(rng.integers(3, cfg.vocab_size, n).tolist(),
                               max_new_tokens=3, stop_at_eos=False))
            for n in (5, 20, 9)]
    eng.run()
    spans = [s for s in tr.drain() if "id" in s]
    by_rid = collections.defaultdict(dict)
    attn = collections.Counter()
    for s in spans:
        if s["name"] == "model.attention":   # a forward's, by parent
            attn[s["parent"]] += 1
        elif "rid" in s:
            by_rid[s["rid"]][s["name"]] = s
    assert set(by_rid) == {r.rid for r in reqs}
    for r in reqs:
        got = by_rid[r.rid]
        assert set(got) == {"serve.queue", "serve.admit", "serve.prefill",
                            "serve.first_token", "serve.splice"}
        admit = got["serve.admit"]
        for child in ("serve.prefill", "serve.first_token", "serve.splice"):
            assert got[child]["parent"] == admit["id"]
        # the first token is prefill's: an argmax read, no second forward
        assert attn[got["serve.first_token"]["id"]] == 0
        q = got["serve.queue"]
        assert q["t0"] + q["dur"] == admit["t0"]
        assert got["serve.first_token"]["positions"] == 1
    # the third request waited for a slot: a step's decode and more
    assert by_rid[reqs[2].rid]["serve.queue"]["dur"] > \
        by_rid[reqs[0].rid]["serve.queue"]["dur"]
    decodes = [s for s in spans if s["name"] == "serve.decode"]
    assert len(decodes) == eng.decode_steps
    assert all(1 <= s["live"] <= 2 and "rid" not in s for s in decodes)
    assert eng.prefills == 3 and eng.prefill_s > 0


def test_a_span_starts_where_the_profiler_says_it_does():
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.active(CPU):
            for _ in range(3):
                with span("obs.clock_probe"):
                    torch.ones(64) @ torch.ones(64)
            tr.settle()
    mine = [s["t0"] for s in tr.drain()]
    theirs = sorted(e.start_ns() for e in
                    prof.profiler.kineto_results.events()
                    if e.name() == "obs.clock_probe")
    assert len(mine) == len(theirs) == 3
    assert max(abs(a - b) for a, b in zip(sorted(mine), theirs)) < 1_000_000


def _one_traced_step(remat):
    cfg = smoke_config(MOE).replace(remat=remat)
    tr = Tracer()
    trainer = _trained(cfg, tr)
    tr.settle(wait=True)
    names = collections.Counter(s["name"] for s in tr.drain()
                                if "id" in s)
    return names, trainer.step_times[0]


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_a_recompute_records_no_span_and_counts_no_pair(remat):
    names, times = _one_traced_step(remat)
    plain_names, plain = _one_traced_step("none")
    layers = smoke_config(MOE).num_layers
    assert plain_names["model.attention"] == layers
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert plain_names[name] == layers
    assert names == plain_names
    assert times["moe_pairs"] == plain["moe_pairs"] > 0
    assert times["moe_pairs_kept"] == plain["moe_pairs_kept"]


@pytest.mark.parametrize("layout", ["global", "per_row"])
def test_pair_counters_equal_a_count_from_expert_slots(layout, monkeypatch):
    cfg = smoke_config(MOE).replace(capacity_factor=0.5)
    p = api.init_params(cfg, torch.Generator().manual_seed(3))
    moe = {k: v[0] for k, v in p["layers"]["moe"].items()}
    b, s = 2, 48
    if layout == "per_row":
        monkeypatch.setattr(M, "_GLOBAL_ROUTE_MAX_TOKENS", s)
    x = torch.randn(b, s, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    tr = Tracer()
    with tr.active(CPU):
        M.moe_ffn(cfg, moe, x)
        counts = {r["name"]: r["count"] for r in tr.settle()
                  if "count" in r}
    logits = x.float() @ moe["router"]
    _, idx = M._route(logits, cfg.experts_per_token)
    if layout == "global":
        idx, cap = idx.reshape(1, b * s, -1), M._capacity(cfg, b * s)
    else:
        cap = M._capacity(cfg, s)
    _, keep, _ = M.expert_slots(idx, cfg.num_experts, cap)
    assert counts["moe.pairs_routed"] == b * s * cfg.experts_per_token
    assert counts["moe.pairs_kept"] == int(keep.sum())
    assert 0 < counts["moe.pairs_kept"] < counts["moe.pairs_routed"]


def test_trainer_step_times_keys_with_and_without_a_tracer():
    cfg = smoke_config(MOE)
    plain = _trained(cfg, steps=2)
    assert [set(t) for t in plain.step_times] == [STEP_KEYS] * 2
    tr = Tracer()
    traced = _trained(cfg, tr, steps=2)
    assert [set(t) for t in traced.step_times] == [TRACED_KEYS] * 2
    for t in traced.step_times:
        assert 0 < t["attn_fwd_s"] < t["grad_s"]
        assert 0 < t["moe_route_fwd_s"] < t["grad_s"]
        assert 0 < t["moe_pairs_kept"] <= t["moe_pairs"]
    tr.settle(wait=True)
    spans = [s for s in tr.drain() if "id" in s]
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == 2
    kids = collections.Counter(s["name"] for s in spans
                               if s["parent"] in {t["id"] for t in steps})
    assert kids == {"train.data_wait": 2, "train.fwd_bwd": 2,
                    "train.optimizer": 2}
