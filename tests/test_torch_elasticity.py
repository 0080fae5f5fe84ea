"""Elastic computing stages (``core/elasticity.py``, ``FeedHandle.scale_up``
/ ``scale_down``) in the port, held to ``repro``: the same seeded tables
and stream, the port's workers on the CPU.

- the control law takes the same decisions as ``repro``'s on the same
  backlog samples (synchronous, against fakes);
- a feed scaled up mid-stream stores rows bitwise equal, by id, to the
  same feed unscaled, and to ``repro``'s unscaled feed (the port's forms of
  ``tests/test_elasticity.py:243`` and the per-stage split);
- scaling up and down under a sustained backlog drops and doubles nothing
  (:299), and a scale-down drains its retired holders exactly once into
  the store, its workers' stats merged into the totals (:365)."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro.core.enrich import queries as RQ
from repro_torch.core.enrich import queries as TQ
from repro_torch.core.intake import Adapter
from repro_torch.core.records import SyntheticTweets

pytestmark = pytest.mark.timeout(180)

SCALE = 0.002
PKGS = {"repro": (rcore, RQ, {}), "port": (tcore, TQ, {"device": "cpu"})}


def make_manager(pkg):
    core, q, kw = PKGS[pkg]
    store = core.RefStore()
    q.make_reference_tables(store, scale=SCALE, seed=7)
    return core.FeedManager(store, **kw)


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


class ReplayAdapter(Adapter):
    """Pre-generated frames replayed at memory speed (sustained backlog)."""

    def __init__(self, frames):
        super().__init__()
        self._frames = frames

    def frames(self):
        for f in self._frames:
            if self._stop.is_set():
                return
            yield f


# ---------------------------------------------------------------------------
# the control law, against fakes
# ---------------------------------------------------------------------------

class FakeHolder:
    def __init__(self):
        self.rows = 0

    def backlog(self):
        return self.rows, self.rows * 100


class FakeHandle:
    def __init__(self, core, spec, partitions):
        self.core = core
        g = SimpleNamespace(gid=0, name="g", elastic=spec,
                            holders=[FakeHolder() for _ in range(partitions)],
                            slots=[self._slot() for _ in range(partitions)])
        self.stage_groups = [g]

    def _slot(self):
        return SimpleNamespace(
            runner=SimpleNamespace(stats=self.core.ComputingStats()),
            thread=SimpleNamespace(is_alive=lambda: True))

    def set_backlog(self, rows):
        g = self.stage_groups[0]
        for h in g.holders:
            h.rows = rows // len(g.holders)
        g.holders[0].rows += rows - sum(h.rows for h in g.holders)

    def scale_up(self, n, stage=0):
        g = self.stage_groups[stage]
        for _ in range(n):
            g.holders.append(FakeHolder())
            g.slots.append(self._slot())
        return n

    def scale_down(self, n, stage=0):
        g = self.stage_groups[stage]
        dropped = 0
        while dropped < n and len(g.holders) > 1:
            g.holders.pop()
            g.slots.pop()
            dropped += 1
        return dropped


def test_control_law_decides_as_repro():
    """One backlog trace (a burst, a plateau, a quiet tail) through both
    controllers with an injected clock: the same partition counts after
    every sample and the same decision log."""
    trace = ([200] * 3 + [400] * 6 + [10_000] * 6 + [150] * 4 + [0] * 14)
    got = {}
    for pkg in PKGS:
        core = PKGS[pkg][0]
        spec = core.ElasticSpec(min_partitions=1, max_partitions=4,
                                up_after=2, down_after=3, cooldown_s=1.0,
                                high_watermark=1.5, low_watermark=0.25)
        h = FakeHandle(core, spec, partitions=1)
        c = core.ElasticityController(h, batch_size=100)
        parts = []
        for i, rows in enumerate(trace):
            h.set_backlog(rows)
            c.step(now=0.4 * i)
            parts.append(len(h.stage_groups[0].holders))
        got[pkg] = (parts, [(d.action, d.partitions, d.gid)
                            for d in c.decisions])
    assert got["port"] == got["repro"]
    parts, decisions = got["port"]
    assert max(parts) == 4 and parts[-1] == 1     # rode up, and back down
    assert {a for a, _, _ in decisions} >= {"up", "down"}


# ---------------------------------------------------------------------------
# scale_up: bitwise equal to the unscaled feed, and to repro's
# ---------------------------------------------------------------------------

def enriched_plan(pkg, name, total, frame, rate=None, split=False):
    core, q, _ = PKGS[pkg]
    p = (core.pipeline(core.SyntheticAdapter(total=total, frame_size=frame,
                                             seed=13, rate=rate), name)
         .parse(batch_size=frame)
         .options(num_partitions=1, coalesce_rows=0)
         .enrich(q.Q1))
    p = p.enrich(q.Q2, partitions=2) if split else p.enrich(q.Q2)
    return (p.filter(lambda b: b["country"] >= 0, name="keep_all")
            .enrich(q.Q3).store())


@pytest.fixture(scope="module")
def repro_unscaled():
    total, frame = 2000, 50
    mgr = make_manager("repro")
    h = mgr.submit(enriched_plan("repro", "plain", total, frame))
    assert h.join(timeout=120).stored == total
    return rows_by_id(h.storage)


def test_scale_up_is_bitwise_the_unscaled_feed_and_repros(repro_unscaled):
    total, frame = 2000, 50
    mgr = make_manager("port")
    h_plain = mgr.submit(enriched_plan("port", "plain", total, frame))
    assert h_plain.join(timeout=120).stored == total
    h = mgr.submit(enriched_plan("port", "scaled", total, frame,
                                 rate=30_000.0))
    time.sleep(0.02)
    added = h.scale_up(2)
    stats = h.join(timeout=120)
    assert stats.stored == total
    assert added >= 1
    # the scaled-up workers run the compiled plan's fused stages
    assert all(r.spec.udf is h.plan.udf for r in h.runners)
    assert stats.peak_partitions[h.stage_groups[0].name] == 1 + added
    plain, scaled = rows_by_id(h_plain.storage), rows_by_id(h.storage)
    assert_same_rows(plain, scaled)
    assert_same_rows(scaled, repro_unscaled)


def test_per_stage_groups_match_the_fused_feed(repro_unscaled):
    """The chain split at Q2 into a group of 2 partitions: not one output
    bit differs from the fused feed (repro's, unscaled)."""
    mgr = make_manager("port")
    plan = enriched_plan("port", "split", 2000, 50,
                         split=True).compile(mgr.refstore)
    assert len(plan.stage_groups) == 2
    h = mgr.submit(plan)
    stats = h.join(timeout=120)
    assert stats.stored == 2000
    assert stats.peak_partitions[plan.stage_groups[1].name] == 2
    assert_same_rows(rows_by_id(h.storage), repro_unscaled)


# ---------------------------------------------------------------------------
# exactly once under scaling
# ---------------------------------------------------------------------------

def test_scaling_during_sustained_ingestion_drops_nothing():
    """Scale up and down repeatedly while a replayed stream keeps every
    holder backlogged: every record reaches the store and the tee once."""
    total, frame = 6000, 25
    frames = list(SyntheticTweets(seed=41).batches(total, frame))
    seen = {}
    lock = threading.Lock()

    def counting_sink(batch):
        ids = batch["id"][batch["valid"]]
        with lock:
            for i in ids.tolist():
                seen[i] = seen.get(i, 0) + 1

    mgr = make_manager("port")
    h = mgr.submit(tcore.pipeline(ReplayAdapter(frames), "stress")
                   .parse(batch_size=frame)
                   .options(num_partitions=1, coalesce_rows=0)
                   .enrich(TQ.Q1).tee(counting_sink, name="count").store())
    stop = threading.Event()

    def churn():
        step = 0
        while not stop.is_set():
            (h.scale_down if step % 3 == 2 else h.scale_up)(1)
            step += 1
            time.sleep(0.01)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        stats = h.join(timeout=120)
    finally:
        stop.set()
        t.join(timeout=10)
    assert stats.stored == total == h.storage.count
    assert len(seen) == total and set(seen.values()) == {1}
    assert stats.scale_ups >= 2 and stats.scale_downs >= 1


def test_scale_down_drains_exactly_once_into_store():
    total, frame = 4000, 25
    frames = list(SyntheticTweets(seed=43).batches(total, frame))
    mgr = make_manager("port")
    h = mgr.submit(tcore.pipeline(ReplayAdapter(frames), "drain")
                   .parse(batch_size=frame)
                   .options(num_partitions=3, coalesce_rows=0,
                            holder_capacity=16)
                   .enrich(TQ.Q1).store())
    time.sleep(0.05)                  # let the holders fill
    dropped = h.scale_down(2)
    stats = h.join(timeout=120)
    assert dropped >= 1
    assert stats.stored == total == h.storage.count
    assert len(h.stage_groups[0].holders) == 3 - dropped
    # the retired workers' counts are in the totals
    assert stats.computing.records == total
    assert stats.computing.per_stage["q1_safety_level"].records == total
    assert stats.computing.invocations == stats.sink_batches["store"]
    assert len(h.runners) == len(h.stage_groups[0].slots)
    ids = rows_by_id(h.storage)["id"]
    np.testing.assert_array_equal(ids, np.arange(total))
