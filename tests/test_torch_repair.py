"""Progressive re-enrichment (``core/repair.py``) held to ``repro``: the
same seeded tables, the same stored rows and the same reference upserts
through both packages' ``RepairJob`` (the port's re-enrichment on the
CPU).  The converged stores must be equal by id (every column exactly,
with dtypes and shapes) and current: equal to a from-scratch enrichment
under the final reference snapshot.  The scheduler's row accounting
(stale, repaired, refined, deleted) must agree too.

Covers the port's forms of ``tests/test_repair.py``'s convergence test
(:238), the racing upsert a clean pass must not swallow (:147), a stateful
stage without repair keys (Q2, coarse), filter deletes, and convergence
under concurrent ingestion through ``FeedManager`` — for Q1 and for the
fused Q1 > Q5 chain, whose two repair-keyed tables (``safety_levels`` and
``suspicious_names``) take rolling upserts.

Q5's spatial columns: ``repro``'s reference path computes |a|^2 + |b|^2 -
2ab, the port dx*dx + dy*dy (ROADMAP Queue 3), and over 1,500 tweets some
pair lies within 0.05 of the radius squared.  So across packages those
three columns are left out (no upsert touches their tables), and each
package's store is held, every column, to its own from-scratch
enrichment."""

import time

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro.core.enrich import queries as RQ
from repro.core.records import SyntheticTweets
from repro_torch.core.enrich import queries as TQ

pytestmark = pytest.mark.timeout(180)

SCALE = 0.002
SPATIAL_Q5 = ("nearby_facility_counts", "nearby_religious_buildings",
              "nearby_building_religions")
PKGS = {"repro": (rcore, RQ, {}), "port": (tcore, TQ, {"device": "cpu"})}


def make_manager(pkg):
    core, q, kw = PKGS[pkg]
    store = core.RefStore()
    q.make_reference_tables(store, scale=SCALE, seed=7)
    return core.FeedManager(store, **kw)


def plan_of(pkg, mgr, udf="q1", total=0, batch=50, refresh=None, rate=None,
            filt=None, **store_kw):
    core, q, _ = PKGS[pkg]
    p = (core.pipeline(core.SyntheticAdapter(total=total, frame_size=batch,
                                             seed=3, rate=rate), "rp")
         .parse(batch_size=batch).options(num_partitions=2)
         .enrich({"q1": q.Q1, "q2": q.Q2, "q1q5": q.Q1.then(q.Q5)}[udf]))
    if filt is not None:
        p = p.filter(filt, name="lvl")
    return p.store(refresh=refresh, **store_kw).compile(mgr.refstore)


def seed_storage(pkg, mgr, plan, nrows, nparts=2, upsert=False):
    """Materialize a store the way the feed would: enrich through a runner
    sharing the manager's predeploy cache, write with lineage."""
    core, _, kw = PKGS[pkg]
    runner = core.ComputingRunner(core.ComputingSpec(plan.udf,
                                                     plan.batch_size),
                                  mgr.refstore, mgr.predeploy, **kw)
    storage = core.StorageJob(nparts, upsert=upsert, **kw)
    for frame in SyntheticTweets(seed=3).batches(nrows, plan.batch_size):
        storage.write(plan.restrict(runner.run(frame)),
                      lineage=runner.last_versions)
    return storage


def repair_job(pkg, mgr, plan, storage):
    core, _, kw = PKGS[pkg]
    return core.RepairJob(plan, storage, mgr.refstore, mgr.predeploy, **kw)


def rows_by_id(storage):
    """Live rows as {column: array} sorted by id (latest occurrence wins)."""
    chunks = list(storage.scan())
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    ids = cols["id"]
    last = len(ids) - 1 - np.unique(ids[::-1], return_index=True)[1]
    order = last[np.argsort(ids[last], kind="stable")]
    return {k: v[order] for k, v in cols.items()}


def assert_same_rows(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def fresh_rows(pkg, mgr, plan, ids):
    """A from-scratch enrichment of the stored tweets under the manager's
    current tables, restricted to the plan's columns, by id."""
    core, _, kw = PKGS[pkg]
    runner = core.ComputingRunner(core.ComputingSpec(plan.udf,
                                                     plan.batch_size),
                                  mgr.refstore, **kw)
    outs = [plan.restrict(runner.run(f)) for f in
            SyntheticTweets(seed=3).batches(int(ids.max()) + 1,
                                            plan.batch_size)]
    cols = {k: np.concatenate([np.asarray(o[k])[np.asarray(o["valid"])]
                               for o in outs]) for k in outs[0]
            if k != "valid"}
    at = np.searchsorted(cols["id"], ids)
    return {k: v[at] for k, v in cols.items()}


def assert_current(pkg, mgr, plan, rows):
    want = fresh_rows(pkg, mgr, plan, rows["id"])
    assert_same_rows({k: rows[k] for k in want}, want)


def upsert_both(mgrs, table, keys, **cols):
    for m in mgrs.values():
        m.refstore[table].upsert(np.asarray(keys, np.int64), **cols)


def stats_of(job):
    s = job.stats
    return (s.stale_rows, s.repaired_rows, s.refined_rows,
            s.invalidated_rows, s.deleted_rows, s.superseded_rows)


# ---------------------------------------------------------------------------
# the scheduler, synchronously
# ---------------------------------------------------------------------------

def test_step_repairs_stale_rows_to_convergence():
    """tests/test_repair.py:238 in both packages: the same stale rows are
    found and repaired, and the converged stores are equal and current."""
    mgrs = {p: make_manager(p) for p in PKGS}
    got = {}
    for pkg, mgr in mgrs.items():
        plan = plan_of(pkg, mgr, refresh=PKGS[pkg][0].RepairSpec())
        storage = seed_storage(pkg, mgr, plan, 200)
        job = repair_job(pkg, mgr, plan, storage)
        assert job.converged()
        got[pkg] = (plan, storage, job)
    upsert_both(mgrs, "safety_levels", np.arange(10),
                safety_level=np.full(10, 4, np.int32))
    for pkg, (plan, storage, job) in got.items():
        assert not job.converged()
        while not job.converged():
            assert job.step(force=True) >= 0
        assert job.stats.repaired_rows == job.stats.stale_rows > 0
        assert storage.count == 200                  # no duplicates
        assert job.step(force=True) == 0             # a further step: no-op
        assert_current(pkg, mgrs[pkg], plan, rows_by_id(storage))
        job.stop()
    assert stats_of(got["port"][2]) == stats_of(got["repro"][2])
    assert_same_rows(rows_by_id(got["repro"][1]), rows_by_id(got["port"][1]))


def test_clean_pass_cannot_swallow_racing_upsert():
    """tests/test_repair.py:147 against the port: a reference write that
    lands after a clean pass re-arms the scheduler, and the store
    converges to the same rows as ``repro``'s."""
    mgrs = {p: make_manager(p) for p in PKGS}
    out = {}
    for pkg, mgr in mgrs.items():
        plan = plan_of(pkg, mgr, refresh=PKGS[pkg][0].RepairSpec())
        storage = seed_storage(pkg, mgr, plan, 100)
        job = repair_job(pkg, mgr, plan, storage)
        assert job.step(force=True) == 0             # clean pass
        assert not job._maybe_stale
        mgr.refstore["safety_levels"].upsert(
            np.arange(10, dtype=np.int64),
            safety_level=np.full(10, 2, np.int32))
        assert job._maybe_stale                      # the listener re-armed
        while not job.converged():
            job.step(force=True)
        assert_current(pkg, mgr, plan, rows_by_id(storage))
        job.stop()
        out[pkg] = rows_by_id(storage)
    assert_same_rows(out["repro"], out["port"])


def test_coarse_repair_of_a_stateful_stage_without_repair_keys():
    """Q2 declares no repair keys: whole units are re-enriched and the
    int64 group-by state rebuilt at the new version, alike in both."""
    mgrs = {p: make_manager(p) for p in PKGS}
    got = {}
    for pkg, mgr in mgrs.items():
        plan = plan_of(pkg, mgr, udf="q2",
                       refresh=PKGS[pkg][0].RepairSpec())
        got[pkg] = (plan, seed_storage(pkg, mgr, plan, 150))
    upsert_both(mgrs, "religious_populations", [0, 1],
                country=np.asarray([3, 3], np.int32),
                religion=np.asarray([1, 2], np.int32),
                population=np.asarray([10_000, 20_000], np.int32))
    jobs = {}
    for pkg, (plan, storage) in got.items():
        job = jobs[pkg] = repair_job(pkg, mgrs[pkg], plan, storage)
        while not job.converged():
            job.step(force=True)
        assert job.stats.refined_rows == 0 < job.stats.repaired_rows
        rows = rows_by_id(storage)
        assert rows["religious_population"].dtype == np.int64
        assert_current(pkg, mgrs[pkg], plan, rows)
        job.stop()
    assert stats_of(jobs["port"]) == stats_of(jobs["repro"])
    assert_same_rows(rows_by_id(got["repro"][1]), rows_by_id(got["port"][1]))


def test_repair_deletes_rows_the_reevaluated_filter_rejects():
    """A stored row the re-run filter rejects is deleted, in both: the
    same rows go, and the survivors are equal."""
    mgrs = {p: make_manager(p) for p in PKGS}
    got = {}
    for pkg, mgr in mgrs.items():
        plan = plan_of(pkg, mgr, filt=lambda b: b["safety_level"] >= 1,
                       refresh=PKGS[pkg][0].RepairSpec(budget_rows_s=1e9))
        got[pkg] = (plan, seed_storage(pkg, mgr, plan, 600))
    upsert_both(mgrs, "safety_levels", np.arange(40),
                safety_level=np.zeros(40, np.int32))
    jobs = {}
    for pkg, (plan, storage) in got.items():
        before = storage.count
        job = jobs[pkg] = repair_job(pkg, mgrs[pkg], plan, storage)
        assert job.drain(timeout=60)
        assert 0 < job.stats.deleted_rows == before - storage.count
        storage.compact()
        rows = rows_by_id(storage)
        assert (rows["safety_level"] >= 1).all()
        assert (rows["country"] >= 40).all()
        job.stop()
    assert stats_of(jobs["port"]) == stats_of(jobs["repro"])
    assert_same_rows(rows_by_id(got["repro"][1]), rows_by_id(got["port"][1]))


# ---------------------------------------------------------------------------
# end to end: convergence under concurrent ingestion and rolling upserts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("udf", ["q1", "q1q5"])
def test_feed_repair_converges_to_repros_store(udf):
    """A feed with repair takes upserts to the repair-keyed tables while it
    ingests; after join both packages' stores hold every row once, equal
    by id, and current under the final tables (the same final tables in
    both: the upserts are the same)."""
    total, batch = 1500, 50
    rng = np.random.default_rng(5)
    waves = [(rng.choice(100, 20, replace=False),
              rng.integers(0, 5, 20).astype(np.int32)) for _ in range(2)]
    out = {}
    for pkg in PKGS:
        core = PKGS[pkg][0]
        mgr = make_manager(pkg)
        sn = mgr.refstore["suspicious_names"].snapshot()
        names = np.asarray(sn.arrays["key"][:sn.size][:40], np.int64)
        plan = plan_of(pkg, mgr, udf=udf, total=total, batch=batch,
                       rate=5000.0,
                       refresh=core.RepairSpec(budget_rows_s=100_000))
        h = mgr.submit(plan)
        for (keys, lvls), stored in zip(waves, (300, 800)):
            deadline = time.monotonic() + 60
            while h.storage.count < stored and time.monotonic() < deadline:
                time.sleep(0.005)
            mgr.refstore["safety_levels"].upsert(keys.astype(np.int64),
                                                 safety_level=lvls)
            if udf == "q1q5":
                mgr.refstore["suspicious_names"].upsert(
                    names, religion=np.full(40, 7, np.int32),
                    threat_level=lvls[:1].repeat(40) + 1)
        stats = h.join(timeout=120)
        assert stats.records_in == stats.stored == total
        assert h.storage.count == total               # nothing duplicated
        assert h.repair is not None and h.repair.converged()
        assert stats.repaired_rows > 0               # stored rows went stale
        rows = rows_by_id(h.storage)
        if udf == "q1q5":
            assert (rows["suspect_threat_level"] > 0).any()
            assert (rows["nearby_religious_buildings"] >= 0).any()
        assert_current(pkg, mgr, plan, rows)
        out[pkg] = {k: v for k, v in rows.items() if k not in SPATIAL_Q5}
    assert_same_rows(out["repro"], out["port"])


# ---------------------------------------------------------------------------
# epoch-fenced writes: ingest upserts win over repair
# ---------------------------------------------------------------------------

def test_concurrent_ingest_upsert_supersedes_repair():
    """Ingestion re-delivers the stored pks, enriched under the new
    versions, before repair reaches the old unit: repair skips them as
    superseded (its write is fenced by the unit's epoch), in both."""
    mgrs = {p: make_manager(p) for p in PKGS}
    got = {}
    for pkg, mgr in mgrs.items():
        plan = plan_of(pkg, mgr, refresh=PKGS[pkg][0].RepairSpec(),
                       upsert=True)
        got[pkg] = (plan, seed_storage(pkg, mgr, plan, 50, nparts=1,
                                       upsert=True))
    upsert_both(mgrs, "safety_levels", np.arange(100),
                safety_level=np.full(100, 7, np.int32))
    jobs = {}
    for pkg, (plan, storage) in got.items():
        job = jobs[pkg] = repair_job(pkg, mgrs[pkg], plan, storage)
        fresh = seed_storage(pkg, mgrs[pkg], plan, 50, nparts=1)
        for chunk in fresh.scan():            # the re-delivered rows
            chunk = dict(chunk, valid=np.ones(len(chunk["id"]), bool))
            storage.write(chunk, lineage={"safety_levels":
                          mgrs[pkg].refstore["safety_levels"].version})
        while not job.converged():
            job.step(force=True)
        assert job.stats.superseded_rows > 0
        assert storage.count == 50
        assert_current(pkg, mgrs[pkg], plan, rows_by_id(storage))
        job.stop()
    assert stats_of(jobs["port"]) == stats_of(jobs["repro"])
    assert_same_rows(rows_by_id(got["repro"][1]), rows_by_id(got["port"][1]))


def test_repair_delete_spares_a_racing_ingest_upsert():
    """The port's form of tests/test_repair.py's racing delete: an ingest
    upsert that lands between repair's scan and its conditional delete is
    not deleted in that pass; a later pass removes the still-failing row,
    and the store converges as ``repro``'s does."""
    out = {}
    for pkg in PKGS:
        mgr = make_manager(pkg)
        plan = plan_of(pkg, mgr, filt=lambda b: b["safety_level"] >= 1,
                       refresh=PKGS[pkg][0].RepairSpec(budget_rows_s=1e9))
        storage = seed_storage(pkg, mgr, plan, 200, upsert=True)
        rows = rows_by_id(storage)
        i = int(np.flatnonzero(rows["country"] < 40)[0])
        victim_pk = int(rows["id"][i])
        victim = {k: v[i] for k, v in rows.items()}
        part = storage.partitions[victim_pk % len(storage.partitions)]
        mgr.refstore["safety_levels"].upsert(
            np.arange(40, dtype=np.int64), safety_level=np.zeros(40, np.int32))
        orig_delete = part.delete_rows
        fired = []

        def racing_delete(ids, global_rows, expect_epoch=None):
            if not fired and np.isin(victim_pk, ids):
                fired.append(True)
                fresh = {k: np.asarray([v]) for k, v in victim.items()}
                fresh["valid"] = np.ones(1, bool)
                part.insert(fresh, upsert=True, lineage={"safety_levels": 0})
            return orig_delete(ids, global_rows, expect_epoch)

        part.delete_rows = racing_delete
        job = repair_job(pkg, mgr, plan, storage)
        try:
            assert job.drain(timeout=60)
        finally:
            job.stop()
            part.delete_rows = orig_delete
        assert fired
        assert storage.get(victim_pk) is None
        storage.compact()
        out[pkg] = rows_by_id(storage)
        assert (out[pkg]["country"] >= 40).all()
    assert_same_rows(out["repro"], out["port"])
