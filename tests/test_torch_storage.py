"""The port's column store (repro_torch/core/storage.py) held to the
reference's on disk: a spill directory written by one package recovers in
the other with equal counts, point reads, lineage, levels and query
results, and the crash-consistency round trips of
tests/test_storage_recovery.py (flush -> recover, latest-wins across
segments, compaction recount, manifest format 3 after a merge, a format-2
manifest recovering as level 0) give the same layout in both packages."""

import json
import os

import numpy as np
import pytest

from repro.core import StorageJob, StoragePartition, agg, col
from repro.core.records import SyntheticTweets, parse_json_lines
from repro.kernels import dispatch_mode
from repro_torch.core import StorageJob as TStorageJob
from repro_torch.core import StoragePartition as TStoragePartition
from repro_torch.core import agg as t_agg
from repro_torch.core import col as t_col

PKG = {"repro": (StorageJob, StoragePartition, col, agg),
       "port": (TStorageJob, TStoragePartition, t_col, t_agg)}


def batch_of(n, seed=1, start_id=0):
    b = parse_json_lines(
        SyntheticTweets(seed=seed, start_id=start_id).raw_lines(n))
    b["safety_level"] = (b["country"] % 5).astype(np.int32)
    return b


def job(pkg, nparts, spill_dir, **kw):
    cls = PKG[pkg][0]
    if pkg == "port":
        kw["device"] = "cpu"
    return cls(nparts, spill_dir=spill_dir, **kw)


def part(pkg, spill_dir, **kw):
    return PKG[pkg][1](0, spill_dir=spill_dir, **kw)


def queries(sj, pkg):
    """A select, a pruned scan and a group-by with every aggregate."""
    _, _, c, a = PKG[pkg]
    qs = [sj.query().select("id", "country", "safety_level"),
          sj.query().where(c("id") < 1030).select("id"),
          sj.query().where(c("safety_level") >= 1).group_by("country")
          .agg(n=a.count(), s=a.sum("created_at"), m=a.mean("created_at"),
               top=a.topk("safety_level", 3, payload="id"))]
    with dispatch_mode("reference"):
        return [q.execute() for q in qs]


def assert_same_results(got, want):
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g.stats.segments_pruned == w.stats.segments_pruned
        assert g.stats.rows_scanned == w.stats.rows_scanned


def write_churned(sj):
    """Two flushed batches, then an upsert of part of the first."""
    b1, b2 = batch_of(60, seed=2), batch_of(60, seed=3, start_id=1000)
    sj.write(b1, lineage={"safety_levels": 3})
    sj.write(b2, lineage={"safety_levels": 5})
    b3 = {k: v[:25].copy() for k, v in b1.items()}
    b3["safety_level"] = np.full(25, 4, np.int32)
    sj.write(b3, lineage={"safety_levels": 6})
    sj.flush()
    return b1, b2


# ---------------------------------------------------------------------------
# one package writes, the other recovers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("writer,reader", [("repro", "port"),
                                           ("port", "repro")])
def test_spill_dir_recovers_in_the_other_package(tmp_path, writer, reader,
                                                 merged):
    d = str(tmp_path)
    sj = job(writer, 2, d, upsert=True, segment_rows=20)
    b1, b2 = write_churned(sj)
    if merged:
        for p in sj.partitions:
            p.merge_segments(0, 3)
    want = queries(sj, writer)
    fresh = job(reader, 2, d, upsert=True).recover()
    assert fresh.count == sj.count == 120
    assert fresh.dead_rows == sj.dead_rows
    for p, q in zip(fresh.partitions, sj.partitions):
        assert p.lineage_units() == q.lineage_units()
        assert p.segment_stats() == q.segment_stats()
        assert p.level_histogram() == q.level_histogram()
    for b in (b1, b2):
        for i in range(0, 60, 7):
            pk = int(b["id"][i])
            g, w = fresh.get(pk), sj.get(pk)
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert_same_results(queries(fresh, reader), want)


# ---------------------------------------------------------------------------
# round trips (tests/test_storage_recovery.py:79, :106, :242, :459, :479)
# ---------------------------------------------------------------------------

def _both(fn, tmp_path):
    """Run ``fn(pkg, dir)`` once per package; return both results."""
    out = {}
    for pkg in PKG:
        d = os.path.join(str(tmp_path), pkg)
        os.makedirs(d)
        out[pkg] = fn(pkg, d)
    return out["repro"], out["port"]


def test_recover_round_trip_counts_index_get_lineage(tmp_path):
    def run(pkg, d):
        sj = job(pkg, 2, d, segment_rows=40)
        write_churned(sj)
        fresh = job(pkg, 2, d).recover()
        assert fresh.count == sj.count
        got = [(p.count, p.lineage_units()) for p in fresh.partitions]
        assert got == [(p.count, p.lineage_units()) for p in sj.partitions]
        return got, [int(fresh.get(pk)["country"])
                     for pk in range(0, 60, 7)]
    want, got = _both(run, tmp_path)
    assert got == want


def test_recover_upsert_latest_wins_across_segments(tmp_path):
    def run(pkg, d):
        p = part(pkg, d, segment_rows=10)
        b = batch_of(10, seed=4)
        p.insert(b, upsert=True, lineage={"t": 1})
        b2 = {k: v.copy() for k, v in b.items()}
        b2["country"] = b["country"] + 100
        p.insert(b2, upsert=True, lineage={"t": 2})
        p.flush()
        fresh = part(pkg, d).recover()
        assert fresh.count == 10
        pk = int(b["id"][3])
        assert int(fresh.get(pk)["country"]) == int(b["country"][3]) + 100
        return [lin for _, _, lin in fresh.lineage_units()]
    want, got = _both(run, tmp_path)
    assert got == want == [{"t": 1}, {"t": 2}]


def test_compaction_recover_round_trip_and_dead_recount(tmp_path):
    def run(pkg, d):
        p = part(pkg, d, segment_rows=10)
        b = batch_of(10, seed=23)
        p.insert(b, upsert=True, lineage={"t": 1})
        b2 = {k: v.copy() for k, v in b.items()}
        b2["country"] = b["country"] + 7
        p.insert(b2, upsert=True, lineage={"t": 2})
        p.flush()
        fresh = part(pkg, d).recover()
        dead = fresh.dead_rows
        dropped = fresh.compact()
        again = part(pkg, d).recover()
        return (dead, dropped, again.count, again.dead_rows,
                [lin for _, _, lin in again.lineage_units()],
                int(again.get(int(b["id"][4]))["country"]))
    want, got = _both(run, tmp_path)
    assert got == want
    assert got[:4] == (10, 10, 10, 0) and got[4] == [{"t": 2}]


def test_merge_manifest_format3_round_trip(tmp_path):
    def run(pkg, d):
        p = part(pkg, d, segment_rows=10)
        for s in range(1, 5):
            p.insert(batch_of(10, seed=s, start_id=s * 1000), upsert=False,
                     lineage={"t": s})
        p.merge_segments(0, 3)
        with open(os.path.join(d, "p0", "MANIFEST.json")) as f:
            doc = json.load(f)
        fresh = part(pkg, d).recover()
        assert fresh.segment_stats() == p.segment_stats()
        fresh.merge_segments(0, 2)
        return (doc["format"], doc["levels"], doc["rows"],
                fresh.segment_stats(), fresh.count)
    want, got = _both(run, tmp_path)
    assert got == want
    assert got[:2] == (3, [1, 0]) and got[3] == [(40, 0, 2)]


def test_format2_manifest_recovers_as_level0(tmp_path):
    def run(pkg, d):
        p = part(pkg, d, segment_rows=10)
        for s in range(1, 4):
            p.insert(batch_of(10, seed=s, start_id=s * 1000), upsert=False,
                     lineage={"t": s})
        p.merge_segments(0, 2)                         # a level-1 segment
        man = os.path.join(d, "p0", "MANIFEST.json")
        with open(man) as f:
            doc = json.load(f)
        del doc["levels"]
        doc["format"] = 2
        with open(man, "w") as f:
            json.dump(doc, f)
        fresh = part(pkg, d).recover()
        return (fresh.count, [lv for _r, _d, lv in fresh.segment_stats()],
                fresh.level_histogram())
    want, got = _both(run, tmp_path)
    assert got == want == (30, [0, 0], {0: 2})
