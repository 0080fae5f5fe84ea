"""The readers of the port's program spans and counters, on synthetic
records: each reads its spans or its ``step_times`` keys, the step
means leave out ``tracer_steps``, and every reader reads ``None`` where
a run holds no program spans (a driver that gave the port no tracer)."""

import pytest

from bench.harness.cell import load_module
from bench.harness.env import BENCH

SERVE = ["admit_prefill_ms", "admit_first_token_ms", "decode_device_ms",
         "queue_wait_p95_ms"]
TRAIN = ["attn_fwd_ms", "moe_route_fwd_ms", "moe_kept_pair_share"]


def reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py")


def span(name, device_s=None, dur=0):
    return {"name": name, "id": 1, "parent": None, "t0": 0, "dur": dur,
            "device_s": device_s}


def test_serving_readers():
    spans = ([span("serve.prefill", s) for s in (0.010, 0.030)]
             + [span("serve.first_token", s) for s in (0.040, 0.050)]
             + [span("serve.decode", s) for s in (0.002, 0.003, 0.004)]
             + [span("serve.queue", dur=ms * 1_000_000)
                for ms in range(1, 101)]
             + [span("serve.admit", 1.0)])
    run = {"spans": spans}
    assert reader("admit_prefill_ms").read(run) == pytest.approx(20.0)
    assert reader("admit_first_token_ms").read(run) == pytest.approx(45.0)
    assert reader("decode_device_ms").read(run) == pytest.approx(3.0)
    assert reader("queue_wait_p95_ms").read(run) == pytest.approx(95.05)
    few = {"spans": [span("serve.queue", dur=5)] * 19}
    assert reader("queue_wait_p95_ms").read(few) is None


def test_training_readers_leave_out_the_tracer_steps():
    times = [{"data_wait_s": 0.0, "grad_s": 1.0, "update_s": 0.1,
              "attn_fwd_s": a, "moe_route_fwd_s": r, "moe_pairs": 100,
              "moe_pairs_kept": k}
             for a, r, k in ((0.05, 0.01, 60), (0.9, 0.9, 62),
                             (0.07, 0.03, 58))]
    run = {"step_times": times, "tracer_steps": [1]}
    assert reader("attn_fwd_ms").read(run) == pytest.approx(60.0)
    assert reader("moe_route_fwd_ms").read(run) == pytest.approx(20.0)
    assert reader("moe_kept_pair_share").read(run) == pytest.approx(60.0)
    dense = [dict(t, moe_pairs=0, moe_pairs_kept=0) for t in times]
    assert reader("moe_kept_pair_share").read({"step_times": dense}) \
        is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_no_program_spans_read_none(name):
    untraced = {"spans": None, "tracer_steps": [],
                "step_times": [{"data_wait_s": 0.0, "grad_s": 1.0,
                                "update_s": 0.1}]}
    assert reader(name).read(untraced) is None
    assert reader(name).read({}) is None
