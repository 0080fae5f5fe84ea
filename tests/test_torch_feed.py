"""The port's feed end to end against the reference: one plan (the same
SyntheticAdapter seed, fused Q1 > Q4 > Q6, 2 partitions, a tee sink and
the column store) through both FeedManagers, the port's on the CPU.  The
enriched rows must be equal when sorted by id, and the same group-by query
must give the same result.

``repro`` takes its reference spatial path here (|a|^2 + |b|^2 - 2ab; the
port computes dx*dx + dy*dy), so the test asserts that no delivered tweet
lies within 0.05 of the radius squared of any monument.  Float sums are
compared per segment to 1e-6 * sum|v| (float32) and 1e-12 * sum|v|
(float64): the two packages add in different orders."""

import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import FeedManager, RefStore, SyntheticAdapter, pipeline
from repro.core.enrich import queries as RQ
from repro.core.query import agg
from repro.kernels import dispatch_mode
from repro_torch.core import FeedManager as TFeedManager
from repro_torch.core import PlanError as TPlanError
from repro_torch.core import SyntheticAdapter as TSyntheticAdapter
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core.enrich import queries as TQ
from repro_torch.core.query import agg as t_agg
from repro_torch.core.refdata import refstore_from_numpy

SCALE = 0.002
TOTAL, FRAME = 800, 200
MARGIN = 0.05


@pytest.fixture(scope="module")
def stores():
    s = RefStore()
    RQ.make_reference_tables(s, scale=SCALE, seed=7)
    tables = {name: s[name].snapshot().arrays
              for name in RQ.PAPER_CARDINALITIES}
    return s, refstore_from_numpy(tables)


def _collect():
    lock, got = threading.Lock(), []

    def sink(batch):
        with lock:
            got.append({k: np.asarray(v) for k, v in batch.items()})
    return got, sink


def _rows(batches):
    cols = {k: np.concatenate([b[k][b["valid"]] for b in batches])
            for k in batches[0]}
    order = np.argsort(cols["id"], kind="stable")
    return {k: v[order] for k, v in cols.items()}


@pytest.fixture(scope="module")
def feeds(stores):
    rstore, tstore = stores
    got_r, sink_r = _collect()
    with dispatch_mode("reference"):
        rfeed = FeedManager(rstore).submit(
            pipeline(SyntheticAdapter(total=TOTAL, frame_size=FRAME,
                                      seed=13), "ref")
            .parse(batch_size=FRAME).options(num_partitions=2, coalesce_rows=0)
            .enrich(RQ.Q1.then(RQ.Q4).then(RQ.Q6))
            .tee(sink_r, name="rows").store())
        rstats = rfeed.join(timeout=300)
        rq = (rfeed.query().group_by("country")
              .agg(n=agg.count(), inc=agg.mean("area_avg_income"),
                   lvl=agg.sum("safety_level")).execute())
    got_t, sink_t = _collect()
    tfeed = TFeedManager(tstore, device="cpu").submit(
        t_pipeline(TSyntheticAdapter(total=TOTAL, frame_size=FRAME,
                                     seed=13), "port")
        .parse(batch_size=FRAME).options(num_partitions=2, coalesce_rows=0)
        .enrich(TQ.Q1.then(TQ.Q4).then(TQ.Q6))
        .tee(sink_t, name="rows").store())
    tstats = tfeed.join(timeout=300)
    tq = (tfeed.query().group_by("country")
          .agg(n=t_agg.count(), inc=t_agg.mean("area_avg_income"),
               lvl=t_agg.sum("safety_level")).execute())
    return (rstats, _rows(got_r), rq), (tstats, _rows(got_t), tq)


def test_feed_delivers_equal_enriched_rows(stores, feeds):
    (rstats, want, _), (tstats, got, _) = feeds
    assert rstats.stored == tstats.stored == TOTAL
    a = stores[0]["monuments"].snapshot().arrays
    ok = a["key"] != np.iinfo(np.int64).max
    dx = got["lat"][:, None].astype(np.float64) - a["lat"][ok][None]
    dy = got["lon"][:, None].astype(np.float64) - a["lon"][ok][None]
    assert np.abs(dx * dx + dy * dy - 1.5 ** 2).min() > MARGIN
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["nearby_monument_count"] > 0).any()
    assert (got["district"] >= 0).any()


def test_feed_group_by_query_matches(feeds):
    (_, _, rq), (_, _, tq) = feeds
    np.testing.assert_array_equal(tq["country"], rq["country"])
    np.testing.assert_array_equal(tq["n"], rq["n"])
    np.testing.assert_array_equal(tq["lvl"], rq["lvl"])
    assert tq["lvl"].dtype == rq["lvl"].dtype == np.int64
    # mean = float64 sum / count; sums may add in another order
    assert tq["inc"].dtype == rq["inc"].dtype == np.float64
    tol = 1e-12 * np.abs(rq["inc"]) + 1e-300
    assert np.all(np.abs(tq["inc"] - rq["inc"]) <= tol)


def test_feed_counters_and_dispatch_paths(feeds):
    (rstats, _, _), (tstats, _, tq) = feeds
    inv = tstats.computing.invocations
    assert tstats.sink_batches == {"rows": inv, "store": inv}
    # one fused apply + one Q6 state entry; both invoked per batch
    assert tstats.predeploy["compiles"] == 2
    assert tstats.predeploy["invocations"] == 2 * inv
    # CPU tensors take the plain versions, recorded as "reference"
    assert tq.stats.agg_kernel_dispatches == 0
    assert tq.stats.agg_fallback_dispatches > 0


def test_float32_segment_sums_within_order_tolerance(stores):
    """Q6's state counts are int32 (exact); a float32 sum through the
    port's segment_sum is held to 1e-6 * sum|v| per segment."""
    from repro.core.enrich import ops as r_ops
    from repro_torch.core.enrich import ops as t_ops
    rng = np.random.default_rng(4)
    v = rng.normal(size=5000).astype(np.float32)
    seg = rng.integers(0, 37, 5000).astype(np.int32)
    want = np.asarray(r_ops._segment_sum_ref(v, seg, 37))
    got = t_ops.segment_sum(torch.from_numpy(v), torch.from_numpy(seg),
                            37).numpy()
    assert got.dtype == want.dtype == np.float32
    scale = np.bincount(seg, np.abs(v), 37)
    assert np.all(np.abs(got - want) <= 1e-6 * scale)


def test_bad_plan_raises_at_compile_time_on_meta(stores):
    """Plan validation runs the stages on meta tensors: a stage reading a
    missing column or returning a scalar fails before any feed starts."""
    def bad_apply(batch, state, refs):
        return {"x": batch["no_such_column"] + 1}

    def scalarizing(batch, state, refs):
        return {"x": batch["country"].sum()}

    tstore = stores[1]
    for fn, match in ((bad_apply, "bad_udf"), (scalarizing, "batch-aligned")):
        bad = TQ.EnrichUDF("bad_udf", (), None, fn, "broken")
        mgr = TFeedManager(tstore, device="cpu")
        with pytest.raises(TPlanError, match=match):
            mgr.submit(t_pipeline(TSyntheticAdapter(total=10, frame_size=10),
                                  "bad").enrich(TQ.Q1).enrich(bad).store())
        assert mgr.feeds == {}
    # the full Q1 > Q4 > Q6 chain validates on meta without computing
    plan = (t_pipeline(TSyntheticAdapter(total=10, frame_size=10), "ok")
            .parse(batch_size=6720).enrich(TQ.Q1.then(TQ.Q4).then(TQ.Q6))
            .store().compile(tstore))
    assert "area_avg_income" in plan.output_columns


def test_entry_points_raise_without_cuda(stores):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TFeedManager(stores[1])
    from repro_torch.core import ComputingRunner, ComputingSpec
    with pytest.raises(RuntimeError, match="CUDA"):
        ComputingRunner(ComputingSpec(TQ.Q1, 8), stores[1])


def test_port_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch.core, repro_torch.kernels.hash_probe, "
            "repro_torch.kernels.spatial_join, "
            "repro_torch.kernels.segment_reduce, "
            "repro_torch.kernels.segment_topk, "
            "repro_torch.kernels.flash_attention, repro_torch.models.api, "
            "repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.train, repro_torch.train.data_feed, "
            "repro_torch.train.trainer, repro_torch.train.compression, "
            "repro_torch.ckpt, repro_torch.data.packing, "
            "repro_torch.runtime, repro_torch.launch.train, "
            "repro_torch.models.moe_ep, repro_torch.models.sharding, "
            "repro_torch.runtime.elastic;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
