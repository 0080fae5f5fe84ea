"""The port's read path (repro_torch/core/query.py over its StorageJob)
held to the reference's: the same numpy batches go into both packages'
stores, the same query runs on both, and every result column must be
equal, with the same dtype and shape.  The cases mirror
tests/test_query.py; a parametrised top-k case sweeps k and the group
count across the segment_topk kernel envelope (at most 2048 segments),
with negative and tied values.

``repro`` runs its plain versions (``dispatch_mode("reference")``): its
segment_topk Pallas kernel does not run on the installed jax, so the
top-k is held to ``kernels/segment_topk/ref.py`` and
``ops._segment_topk_ref``, never to the Pallas kernel.  The port runs on
the CPU, where its wrappers take their plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CompactionJob, CompactionSpec, QueryError, \
    StorageJob, StoreSnapshot, agg, col
from repro.core.enrich import ops as r_ops
from repro.core.records import SyntheticTweets, parse_json_lines
from repro.kernels import dispatch_mode
from repro_torch.core import CompactionJob as TCompactionJob
from repro_torch.core import CompactionSpec as TCompactionSpec
from repro_torch.core import QueryError as TQueryError
from repro_torch.core import StorageJob as TStorageJob
from repro_torch.core import StoreSnapshot as TStoreSnapshot
from repro_torch.core import agg as t_agg
from repro_torch.core import col as t_col
from repro_torch.core.enrich import dispatch as t_dispatch

# QueryStats fields both packages count the same way (the dispatch-path
# split differs by design: the port has no 64-bit fallback)
STATS = ("units", "units_pruned", "segments", "segments_pruned",
         "rows_scanned", "rows_live", "rows_matched", "agg_invocations",
         "agg_batched_units")


def batch_of(n, seed=1, start_id=0):
    b = parse_json_lines(
        SyntheticTweets(seed=seed, start_id=start_id).raw_lines(n))
    b["safety_level"] = (b["country"] % 5).astype(np.int32)
    return b


class Both:
    """One store in each package, fed the same batches."""

    def __init__(self, tmp_path=None, nparts=2, segment_rows=40,
                 upsert=True, **kw):
        def spill(tag):
            return str(tmp_path / tag) if tmp_path is not None else None
        self.spill = (spill("r"), spill("t"))
        self.r = StorageJob(nparts, spill_dir=self.spill[0], upsert=upsert,
                            segment_rows=segment_rows, **kw)
        self.t = TStorageJob(nparts, spill_dir=self.spill[1], upsert=upsert,
                             segment_rows=segment_rows, device="cpu", **kw)

    def write(self, b, lineage=None):
        lin = lineage or {"t": 1}
        self.r.write({k: v.copy() for k, v in b.items()}, lineage=lin)
        self.t.write({k: v.copy() for k, v in b.items()}, lineage=lin)

    def fill(self, total=400, batch=80, seed=3):
        for f in SyntheticTweets(seed=seed).batches(total, batch):
            b = parse_json_lines(f)
            b["safety_level"] = (b["country"] % 5).astype(np.int32)
            self.write(b)
        return self

    def flush(self):
        self.r.flush()
        self.t.flush()

    def query(self, build, **kw):
        """``build(query, col, agg)`` on both stores; results held equal.
        Returns (repro's, the port's)."""
        with dispatch_mode("reference"):
            want = build(self.r.query(), col, agg).execute(**kw)
        got = build(self.t.query(), t_col, t_agg).execute(**kw)
        assert_equal(got, want)
        return want, got


def assert_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)
    for f in STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.watermark == want.watermark


# ---------------------------------------------------------------------------
# scans (tests/test_query.py:149, :175, :189)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prune", [True, False])
def test_scan_with_and_without_pruning_matches(tmp_path, prune):
    s = Both(tmp_path).fill()
    s.flush()
    want, got = s.query(lambda q, c, a: q.where(
        (c("safety_level") >= 3) & (c("id") < 250)).select(
            "id", "safety_level"), prune=prune)
    assert (got.stats.segments_pruned > 0) == prune
    assert got.rows > 0


def test_latest_wins_over_upsert_churn_and_callable_predicate():
    s = Both(segment_rows=10_000).fill()
    b = batch_of(60, seed=3)
    b["safety_level"] = np.full(60, 9, np.int32)
    s.write(b, lineage={"t": 2})
    _, got = s.query(lambda q, c, a: q.where(
        lambda cols: cols["safety_level"] == 9).select("id"))
    assert got.rows == 60


def test_deleted_rows_drop_out_of_queries():
    s = Both(segment_rows=10_000).fill(total=100)
    for sj in (s.r, s.t):
        p0 = sj.partitions[0]
        with p0._lock:
            ids = p0._index._pks[:5].copy()
            rows = p0._index._rows[:5].copy()
        assert p0.delete_rows(ids, rows) == 5
    _, got = s.query(lambda q, c, a: q.select("id"))
    assert got.rows == s.t.count == s.r.count == 95
    s.r.compact()
    s.t.compact()
    assert s.t.dead_rows == s.r.dead_rows == 0
    s.query(lambda q, c, a: q.select("id"))


# ---------------------------------------------------------------------------
# group-by aggregation (tests/test_query.py:210, :234, :271, :325)
# ---------------------------------------------------------------------------

def _full_agg(q, c, a):
    return (q.where(c("safety_level") >= 1).group_by("country")
            .agg(n=a.count(), total=a.sum("created_at"),
                 m=a.mean("created_at"),
                 top=a.topk("safety_level", k=3, payload="id")))


def test_group_agg_matches(tmp_path):
    s = Both(tmp_path, segment_rows=64).fill(total=500, seed=7)
    s.flush()
    _, got = s.query(_full_agg)
    assert got["total"].dtype == np.int64 and got.stats.agg_invocations


@pytest.mark.parametrize("batched", [True, False])
def test_batched_and_eager_agg_match(tmp_path, batched):
    s = Both(tmp_path, segment_rows=32).fill(total=400, seed=11)
    s.write(batch_of(100, seed=11), lineage={"t": 2})     # upsert churn
    s.flush()
    _, got = s.query(_full_agg, batched=batched)
    assert (got.stats.agg_batched_units > 1) == batched


def test_batched_bare_count_without_group(tmp_path):
    s = Both(tmp_path, segment_rows=32).fill(total=200)
    s.flush()
    _, got = s.query(lambda q, c, a: q.agg(n=a.count()))
    assert got["n"].tolist() == [200]


def test_global_agg_without_group_by():
    s = Both().fill(total=200)
    _, got = s.query(lambda q, c, a: q.agg(n=a.count(),
                                           s=a.sum("safety_level")))
    assert got["n"].tolist() == [200]


# ---------------------------------------------------------------------------
# merge and compaction (tests/test_query.py:279, :336)
# ---------------------------------------------------------------------------

def test_agg_results_stable_across_leveled_merge(tmp_path):
    s = Both(tmp_path, nparts=1, segment_rows=32, sort_key="country")
    s.fill(total=400, seed=13)
    s.write(batch_of(100, seed=13), lineage={"t": 2})
    s.flush()

    def q(q, c, a):
        return (q.where(c("safety_level") >= 1).group_by("country")
                .agg(n=a.count(), total=a.sum("created_at"),
                     top=a.topk("safety_level", k=2, payload="id")))
    before, _ = s.query(q)
    segs = s.t.segment_count
    assert s.r.segment_count == segs
    rj = CompactionJob(s.r, CompactionSpec(merge_fanin=8,
                                           level_target_rows=100_000))
    tj = TCompactionJob(s.t, TCompactionSpec(merge_fanin=8,
                                             level_target_rows=100_000))
    assert tj.merge_now() == rj.merge_now() > 0
    assert s.t.segment_count == s.r.segment_count < segs
    assert s.t.level_histogram() == s.r.level_histogram()
    after, _ = s.query(q)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])


def test_agg_results_stable_across_compaction(tmp_path):
    s = Both(tmp_path, segment_rows=50).fill(total=300)
    s.write(batch_of(120, seed=3), lineage={"t": 2})
    s.flush()

    def q(q, c, a):
        return (q.group_by("safety_level")
                .agg(n=a.count(), top=a.topk("safety_level", 2)))
    before, _ = s.query(q)
    assert s.t.dead_rows == s.r.dead_rows == 120
    assert s.t.compact() == s.r.compact() == 120
    after, _ = s.query(q)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])


# ---------------------------------------------------------------------------
# top-k (tests/test_query.py:397) and the kernel envelope sweep
# ---------------------------------------------------------------------------

def test_topk_int64_in_range_exact_and_wide_values_rejected():
    s = Both(segment_rows=10_000)
    b = batch_of(8, seed=32)
    b["big"] = np.int64(2) ** 31 - 100 + np.arange(8, dtype=np.int64)
    b["safety_level"] = np.zeros(8, np.int32)
    s.write(b)
    _, got = s.query(lambda q, c, a: q.group_by("safety_level").agg(
        top=a.topk("big", k=3, payload="id")))
    assert got["top"].tolist() == [[int(b["id"][i]) for i in (7, 6, 5)]]
    b2 = {k: v.copy() for k, v in b.items()}
    b2["id"] = b["id"] + 100
    b2["big"] = b["big"] + 200                         # crosses 2^31
    s.write(b2)
    for sj, err in ((s.r, QueryError), (s.t, TQueryError)):
        with pytest.raises(err, match="int32 range"):
            sj.query().group_by("safety_level").agg(
                t=(agg if sj is s.r else t_agg).topk("big", k=1)).execute()
        with pytest.raises(err, match="integer"):
            sj.query().group_by("safety_level").agg(
                t=(agg if sj is s.r else t_agg).topk("lat", k=1)).execute()


@pytest.mark.parametrize("groups", [1, 128, 2048, 2049])
@pytest.mark.parametrize("k", [1, 3, 16])
def test_topk_across_the_kernel_envelope(tmp_path, groups, k):
    """group counts at and past the kernel's 2048 segments (2049 pads to
    4096 and takes the composite sort on every device), values with
    negatives and dense ties, eager and batched."""
    rng = np.random.default_rng(groups * 31 + k)
    n = max(3 * groups, 600)
    b = batch_of(n, seed=groups + k)
    b["g"] = rng.permutation(np.arange(n) % groups).astype(np.int64)
    b["v"] = rng.integers(-3, 4, n).astype(np.int32)
    s = Both(tmp_path, segment_rows=max(n // 6, 100))
    s.write(b)
    churn = {key: v[: n // 5].copy() for key, v in b.items()}
    churn["v"] = rng.integers(-3, 4, n // 5).astype(np.int32)
    s.write(churn, lineage={"t": 2})                   # superseded rows
    s.flush()
    for batched in (True, False):
        _, got = s.query(lambda q, c, a: q.group_by("g").agg(
            n=a.count(), top=a.topk("v", k, payload="id")),
            batched=batched)
        assert got["top"].shape == (groups, k)
    with TStoreSnapshot(s.t) as snap, StoreSnapshot(s.r) as rsnap:
        assert snap.live_rows == rsnap.live_rows == n


# ---------------------------------------------------------------------------
# zone maps through recovery (tests/test_query.py:448)
# ---------------------------------------------------------------------------

def test_zone_maps_recover_and_legacy_manifests_never_prune(tmp_path):
    import json
    import os
    s = Both(tmp_path, nparts=1, segment_rows=50).fill(total=150)
    s.flush()
    fresh = Both(tmp_path, nparts=1)
    fresh.r.recover()
    fresh.t.recover()
    _, r1 = fresh.query(lambda q, c, a: q.where(c("id") < 40).select("id"))
    assert r1.stats.segments_pruned > 0
    for d in s.spill:
        man = os.path.join(d, "p0", "MANIFEST.json")
        with open(man) as f:
            m = json.load(f)
        del m["zone_maps"]
        with open(man, "w") as f:
            json.dump(m, f)
    legacy = Both(tmp_path, nparts=1)
    legacy.r.recover()
    legacy.t.recover()
    _, r2 = legacy.query(lambda q, c, a: q.where(c("id") < 40).select("id"))
    assert r2.stats.segments_pruned == 0
    np.testing.assert_array_equal(r1["id"], r2["id"])


# ---------------------------------------------------------------------------
# the dispatch layer's top-k against the reference's oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,s,k", [(700, 128, 3), (3000, 2048, 16),
                                   (50, 1, 1), (900, 4096, 2)])
def test_segment_topk_dispatch_matches_reference_oracle(r, s, k):
    """payload + unclipped values, negatives and ties, a valid mask and
    rows routed past the last segment (the query's padding)."""
    rng = np.random.default_rng(r + s + k)
    vals = rng.integers(-4, 5, r).astype(np.int32)
    seg = rng.integers(0, s + 1, r).astype(np.int32)
    pay = rng.permutation(r).astype(np.int64) * 7
    valid = rng.random(r) < 0.9
    gp, gv = t_dispatch.segment_topk(
        torch.from_numpy(vals), torch.from_numpy(seg), torch.from_numpy(pay),
        s, k, torch.from_numpy(valid))
    seg_r = np.where(seg < s, seg, s)
    wp, wv = r_ops._segment_topk_ref(jnp.asarray(vals), jnp.asarray(seg_r),
                                     jnp.asarray(pay), s, k,
                                     jnp.asarray(valid))
    for g, w in ((gp, wp), (gv, wv)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    if s > 1:
        assert (gv.numpy() < 0).any()                 # unclipped values
