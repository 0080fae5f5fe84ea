"""The port's plan API, intake, computing models and observability held to
``repro`` on the same seeded tables and stream (the port on the CPU).

- the port's fused Q1 > Q2 > ... > Q7 chain equals ``repro``'s sequential
  dispatch (seven computing jobs, one UDF each), column for column, and
  the port's own sequential dispatch bit for bit (the port's forms of
  ``tests/test_pipeline_api.py:44``);
- ``tee`` delivers every batch to every sink exactly once (:138), a fused
  ``filter`` drops the same rows, and version-gated per-stage states are
  built and reused as often as ``repro``'s;
- Models 1, 2 and 3 under an upsert between batches
  (``examples/enrichment_freshness.py``): FRESH for 1 and 2, STALE for 3,
  in both packages, with the same state-build counts;
- ``SyntheticAdapter`` and ``FileAdapter`` replay from an offset, and a
  closed partition holder refuses pushes;
- a durable feed with repair exports the same metric names from both
  registries (the kernel-routing tape aside: ``repro`` names its int64
  segment sum's path ``xla_64bit``, the port ``reference`` on the CPU) and
  the same row counts.

Spatial outputs (Q4, Q5, Q7): ``repro``'s reference path computes |a|^2 +
|b|^2 - 2ab, the port dx*dx + dy*dy, so the chain test first asserts that
no tweet lies within 0.05 of a radius squared of any reference point."""

import threading

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro.core.enrich import queries as RQ
from repro.core.records import SyntheticTweets, parse_json_lines
from repro_torch.core.enrich import queries as TQ
from repro_torch.core.records import empty_batch

pytestmark = pytest.mark.timeout(180)

SCALE = 0.002
MARGIN = 0.05
PKGS = {"repro": (rcore, RQ, {}), "port": (tcore, TQ, {"device": "cpu"})}
CHAIN = ("q1", "q2", "q3", "q4", "q5", "q6", "q7")
SPATIAL = {"monuments": 1.5, "religious_buildings": 3.0, "facilities": 3.0}


def make_manager(pkg):
    core, q, kw = PKGS[pkg]
    store = core.RefStore()
    q.make_reference_tables(store, scale=SCALE, seed=7)
    return core.FeedManager(store, **kw)


def runner(pkg, mgr, udf, batch):
    core, _, kw = PKGS[pkg]
    return core.ComputingRunner(core.ComputingSpec(udf, batch),
                                mgr.refstore, mgr.predeploy, **kw)


def assert_same_columns(want, got, cols):
    for k in cols:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def rows_by_id(storage):
    chunks = list(storage.scan())
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    order = np.argsort(cols["id"], kind="stable")
    return {k: v[order] for k, v in cols.items()}


# ---------------------------------------------------------------------------
# fusion: the whole workload in one apply equals sequential dispatch
# ---------------------------------------------------------------------------

def test_fused_chain_matches_repros_sequential_dispatch():
    lines = SyntheticTweets(seed=8).raw_lines(64)
    tw = parse_json_lines(lines)
    mgrs = {p: make_manager(p) for p in PKGS}
    for table, r in SPATIAL.items():
        a = mgrs["repro"].refstore[table].snapshot().arrays
        ok = a["key"] != np.iinfo(np.int64).max
        dx = tw["lat"][:, None].astype(np.float64) - a["lat"][ok][None]
        dy = tw["lon"][:, None].astype(np.float64) - a["lon"][ok][None]
        assert np.abs(dx * dx + dy * dy - r * r).min() > MARGIN, table
    rq = [RQ.get_udf(n) for n in CHAIN]
    tq = [TQ.get_udf(n) for n in CHAIN]
    seq = dict(parse_json_lines(lines))
    for u in rq:
        seq = runner("repro", mgrs["repro"], u, 64).run(seq)
    fused_udf = tq[0]
    for u in tq[1:]:
        fused_udf = fused_udf.then(u)
    fused = runner("port", mgrs["port"], fused_udf, 64)
    got = fused.run(list(lines))
    assert fused.stats.invocations == 1
    outs = sorted(set(got) - set(tw))
    assert len(outs) == 16                       # Q1..Q7's output columns
    assert_same_columns(seq, got, outs)
    # every spatial join found a match (seed 8's tweets reach all three
    # tables while clearing the margin; the 4 districts, 10 attack events
    # and 2,000 of 1,000,000 user names of scale 0.002 stay mostly unhit)
    for k in ("nearby_monument_count", "nearby_facility_counts"):
        assert (np.asarray(got[k]) > 0).any(), k
    assert (np.asarray(got["nearby_religious_buildings"]) >= 0).any()


def test_fused_chain_bitwise_matches_the_ports_sequential_dispatch():
    """On more tweets than the spatial margin allows across packages: the
    port's fused chain against the port's own seven computing jobs."""
    lines = SyntheticTweets(seed=21).raw_lines(512)
    mgr = make_manager("port")
    udfs = [TQ.get_udf(n) for n in CHAIN]
    seq = list(lines)
    for u in udfs:
        seq = runner("port", mgr, u, 512).run(seq)
    fused = TQ.chain("whole", *udfs)
    got = runner("port", mgr, fused, 512).run(list(lines))
    assert_same_columns(seq, got, set(got))


def test_fused_plan_with_tee_and_filter_stores_repros_rows():
    """Q1 > Q2 > Q3 with a filter and two tees through both FeedManagers:
    each tee sees every kept row once, one apply per batch, and the stored
    rows are equal by id."""
    out = {}
    for pkg in PKGS:
        core, q, _ = PKGS[pkg]
        mgr = make_manager(pkg)
        lock, got = threading.Lock(), {"a": [], "b": []}

        def sink(key):
            def f(batch):
                with lock:
                    got[key].append(np.asarray(batch["id"])[
                        np.asarray(batch["valid"])])
            return f

        h = mgr.submit(core.pipeline(core.SyntheticAdapter(
            total=600, frame_size=50, seed=4), "tee")
            .parse(batch_size=50).options(num_partitions=2, coalesce_rows=0)
            .enrich(q.Q1).enrich(q.Q2)
            .filter(lambda b: b["country"] < 128, name="low")
            .enrich(q.Q3)
            .tee(sink("a"), name="a").tee(sink("b"), name="b").store())
        stats = h.join(timeout=120)
        inv = stats.computing.invocations
        assert inv == 12                           # one apply per frame
        assert stats.sink_batches == {"a": inv, "b": inv, "store": inv}
        rows = rows_by_id(h.storage)
        assert 0 < stats.stored == len(rows["id"]) < 600
        assert (rows["country"] < 128).all()
        for key in ("a", "b"):
            ids = np.sort(np.concatenate(got[key]))
            np.testing.assert_array_equal(ids, rows["id"])   # exactly once
        out[pkg] = rows
    assert_same_columns(out["repro"], out["port"], out["repro"])


def test_per_stage_state_reuse_is_version_gated_alike():
    counts = {}
    for pkg in PKGS:
        core, q, _ = PKGS[pkg]
        mgr = make_manager(pkg)
        stats = mgr.submit(core.pipeline(core.SyntheticAdapter(
            total=500, frame_size=100, seed=9), "gated")
            .parse(batch_size=100, refresh="version")
            .options(num_partitions=1, coalesce_rows=0)
            .enrich(q.Q2).enrich(q.Q3).store()).join(timeout=120)
        per = stats.computing.per_stage
        counts[pkg] = {s: (per[s].state_builds, per[s].state_reuses)
                       for s in ("q2_religious_population",
                                 "q3_largest_religions")}
    assert counts["port"] == counts["repro"]
    assert all(b == 1 and r >= 1 for b, r in counts["port"].values())


# ---------------------------------------------------------------------------
# Models 1/2/3 under an upsert (examples/enrichment_freshness.py)
# ---------------------------------------------------------------------------

def tweet_batch(country, n=8):
    b = empty_batch(n)
    b["id"][:] = np.arange(n)
    b["country"][:] = country
    b["valid"][:] = True
    return b


def test_computing_models_see_upserts_as_repro_does():
    models = {"model1_per_record": ("per_record",),
              "model2_per_batch": ("per_batch", "always"),
              "model2_version_gated": ("per_batch", "version"),
              "model3_stream": ("stream",)}
    seen = {}
    for pkg in PKGS:
        core, q, kw = PKGS[pkg]
        store = core.RefStore()
        t = store.create("religious_populations", 64,
                         {"country": np.int32, "religion": np.int32,
                          "population": np.int32})
        t.upsert(np.array([0], np.int64), country=np.array([7], np.int32),
                 religion=np.array([1], np.int32),
                 population=np.array([1000], np.int32))
        runs = {name: core.ComputingRunner(core.ComputingSpec(q.Q2, 8, *m),
                                           store, **kw)
                for name, m in models.items()}
        first = {n: int(r.run(tweet_batch(7))["religious_population"][0])
                 for n, r in runs.items()}
        t.upsert(np.array([1], np.int64), country=np.array([7], np.int32),
                 religion=np.array([2], np.int32),
                 population=np.array([5000], np.int32))
        second = {n: np.asarray(r.run(tweet_batch(7))["religious_population"])
                  for n, r in runs.items()}
        for _ in range(3):                     # quiet batches
            for n in ("model2_per_batch", "model2_version_gated"):
                runs[n].run(tweet_batch(7))
        seen[pkg] = (first, {n: v.tolist() for n, v in second.items()},
                     {n: int(r.stats.state_builds) for n, r in runs.items()})
        assert second["model2_per_batch"].dtype == np.int64
    assert seen["port"] == seen["repro"]
    first, second, builds = seen["port"]
    assert set(first.values()) == {1000}
    for n in ("model1_per_record", "model2_per_batch",
              "model2_version_gated"):
        assert second[n] == [6000] * 8, n        # FRESH
    assert second["model3_stream"] == [1000] * 8  # STALE
    assert builds["model2_per_batch"] == 5 and \
        builds["model2_version_gated"] == 2


# ---------------------------------------------------------------------------
# intake and partition holders
# ---------------------------------------------------------------------------

def test_synthetic_adapter_resumes_to_repros_stream():
    full = [ln for fr in rcore.SyntheticAdapter(
        total=100, frame_size=10, seed=5).frames() for ln in fr]
    re = tcore.SyntheticAdapter(total=100, frame_size=10, seed=5)
    re.resume(37)
    assert [ln for fr in re.frames() for ln in fr] == full[37:]
    assert re.offset == 100
    with pytest.raises(ValueError):
        re.resume(101)


def test_file_adapter_resumes_mid_file(tmp_path):
    path = str(tmp_path / "in.jsonl")
    lines = [b'{"n": %d}' % i for i in range(10)]
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    offs = {}
    for pkg in PKGS:
        ad = PKGS[pkg][0].FileAdapter(path, frame_size=3)
        assert next(ad.frames()) == lines[:3]
        offs[pkg] = ad.offset
        ad.stop()
    assert offs["port"] == offs["repro"]
    re = tcore.FileAdapter(path, frame_size=3)
    re.resume(offs["port"])
    assert [ln for fr in re.frames() for ln in fr] == lines[3:]


def test_holder_close_is_atomic_with_stop_enqueue():
    h = tcore.PartitionHolder(("t", 0), capacity=4)
    h.push([b"a"])
    h.close()
    assert h.closed
    with pytest.raises(RuntimeError, match="closed holder"):
        h.push([b"b"])
    assert h.pull(timeout=0) == [b"a"]
    assert isinstance(h.pull(timeout=0), tcore.StopRecord)


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_registries_export_the_same_metrics(tmp_path):
    metrics, health = {}, {}
    for pkg in PKGS:
        core, q, _ = PKGS[pkg]
        mgr = make_manager(pkg)
        h = mgr.submit(core.pipeline(core.SyntheticAdapter(
            total=600, frame_size=50, seed=3), "obs")
            .parse(batch_size=50).options(num_partitions=2)
            .enrich(q.Q1.then(q.Q2))
            .store(durable=core.DurableSpec(dir=str(tmp_path / pkg)),
                   refresh=core.RepairSpec()))
        h.join(timeout=120)
        metrics[pkg] = h.metrics()
        health[pkg] = h.health()
        text = h.metrics_text()
        assert "# TYPE feed_stored counter" in text
    names = {p: {k for k in m if not k.startswith("dispatch_path_")}
             for p, m in metrics.items()}
    assert names["port"] == names["repro"]
    assert any(k.startswith("wal_") for k in names["port"])
    assert "repair_currency_s" in names["port"]
    assert "dispatch_path_segment_sum_reference" in metrics["port"]
    for k in ("feed_records_in", "feed_stored", "store_rows",
              "computing_records", "feed_repaired_rows", "feed_stale_rows"):
        assert metrics["port"][k] == metrics["repro"][k], k
    assert metrics["port"]["feed_stored"] == 600
    assert health["port"].state == health["repro"].state == "ok"
    assert health["port"].rules == health["repro"].rules


def test_trace_spans_follow_a_batch_as_in_repro():
    """A traced feed in each package: the same span names, and one
    batch's span id seen at intake, at the apply and at the store."""
    names = {}
    for pkg in PKGS:
        core, q, _ = PKGS[pkg]
        mgr = make_manager(pkg)
        h = mgr.submit(core.pipeline(core.SyntheticAdapter(
            total=600, frame_size=50, seed=3), "trace")
            .parse(batch_size=50).options(num_partitions=1, trace=True)
            .enrich(q.Q2).store())
        h.join(timeout=120)
        spans = h.drain_trace()
        names[pkg] = {s["name"] for s in spans}
        ids = {n: {i for s in spans if s["name"].startswith(n)
                   for i in s["spans"]}
               for n in ("intake.draw", "apply.", "store.append")}
        assert ids["intake.draw"] & ids["apply."] & ids["store.append"]
        assert h.drain_trace() == []
    assert names["port"] == names["repro"]
    assert {"intake.draw", "store.append"} <= names["port"]
