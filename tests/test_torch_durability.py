"""Durable feeds across the two packages: ``repro``'s and the port's
``core/durability.py`` + ``core/recovery.py`` on the same seeded tables and
stream (the port on the CPU).

- the WAL segment files, the checkpoint JSON and the torn-tail truncation
  are byte for byte the same;
- crash images (the durable directory copied while a rate-limited durable
  feed runs, in crash-causal order) written by either package resume under
  both with zero rows lost and zero duplicated, and the two resumed stores
  hold equal rows by id (integer columns exactly, with dtypes and shapes;
  float columns are parsed tweet fields and are held exactly too);
- the port's forms of ``tests/test_durability.py``'s crash-image test, its
  live-merging variant, a stop mid-feed, and repair lineage across a
  restart (trusted when the rebuilt tables hash alike, re-scanned when not).

The plan is the fused Q1 > Q2 > Q3 chain: the safety-level probe, the
int64 group-by sum and the (B, 3) top-3 state, all exact integer columns.
Each image is copied twice, so each package resumes a directory of its
own."""

import json
import os
import random
import shutil
import time

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro.core import durability as rdur
from repro.core.enrich import queries as RQ
from repro_torch.core import durability as tdur
from repro_torch.core.enrich import queries as TQ

pytestmark = pytest.mark.timeout(240)

SCALE = 0.002
PKGS = {"repro": (rcore, RQ, {}), "port": (tcore, TQ, {"device": "cpu"})}


def make_manager(pkg):
    core, q, kw = PKGS[pkg]
    store = core.RefStore()
    q.make_reference_tables(store, scale=SCALE, seed=7)
    return core.FeedManager(store, **kw)


def durable_plan(pkg, mgr, d, total, batch=25, rate=None, compact=None,
                 segment_rows=None, **dur_kw):
    core, q, _ = PKGS[pkg]
    store_kw = {} if segment_rows is None else {"segment_rows": segment_rows,
                                                "sort_key": "country"}
    return (core.pipeline(core.SyntheticAdapter(total=total, frame_size=batch,
                                                seed=3, rate=rate), "dp")
            .parse(batch_size=batch)
            .options(num_partitions=2, holder_capacity=16)
            .enrich(q.Q1.then(q.Q2).then(q.Q3))
            .store(durable=core.DurableSpec(dir=str(d), **dur_kw),
                   compact=compact, **store_kw)
            .compile(mgr.refstore))


def stored_ids(storage):
    """Every live pk across all partitions, duplicates included."""
    out = []
    for part in storage.partitions:
        snap = part.snapshot_view()
        try:
            for u in snap.units:
                ids = np.asarray(u.read(("id",))["id"])
                out.append(ids[snap.live_mask(ids, u.base)])
        finally:
            snap.release()
    return np.concatenate(out) if out else np.array([], np.int64)


def assert_exactly_once(storage, total):
    got = stored_ids(storage)
    assert len(got) == len(set(got.tolist())), "duplicate rows stored"
    lost = set(range(total)) - set(got.tolist())
    assert not lost, f"rows lost: {len(lost)}"


def rows_by_id(storage):
    """Live rows as {column: array} sorted by id (latest occurrence wins)."""
    chunks = list(storage.scan())
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    ids = cols["id"]
    # latest occurrence of each id in scan order
    last = len(ids) - 1 - np.unique(ids[::-1], return_index=True)[1]
    order = last[np.argsort(ids[last], kind="stable")]
    return {k: v[order] for k, v in cols.items()}


def assert_same_rows(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def copy_crash_image(src, dst):
    """Copy a live durable dir in crash-causal order: checkpoints, then
    store manifests, then data files (WAL and npz segments), so metadata
    never points at data older than itself.  Files may vanish mid-walk."""
    paths = []
    for root, _, names in os.walk(src):
        for n in names:
            if n.endswith(".tmp"):
                continue
            rank = (0 if n.startswith("CHECKPOINT") else
                    1 if n.startswith("MANIFEST") else 2)
            paths.append((rank, os.path.join(root, n)))
    for _, p in sorted(paths):
        out = os.path.join(dst, os.path.relpath(p, src))
        os.makedirs(os.path.dirname(out), exist_ok=True)
        try:
            shutil.copyfile(p, out)
        except FileNotFoundError:
            continue


def resume_both(img, total, tmp_path, tag, **plan_kw):
    """Resume a copy of ``img`` under each package; returns their
    (handle, stats) after join, each checked exactly once."""
    out = {}
    for pkg in PKGS:
        mine = str(tmp_path / f"{tag}-{pkg}")
        shutil.copytree(img, mine)
        mgr = make_manager(pkg)
        plan = durable_plan(pkg, mgr, tmp_path / "elsewhere", total,
                            **plan_kw)
        h = mgr.resume(plan, durable_dir=mine)
        assert h.durability.recovered
        stats = h.join(timeout=120)
        assert_exactly_once(h.storage, total)
        assert stats.records_in <= total
        out[pkg] = (h, stats)
    return out


# ---------------------------------------------------------------------------
# on-disk formats
# ---------------------------------------------------------------------------

def frames_of(n, k=5):
    return [[b"r-%d-%d" % (i, j) for j in range(k)] for i in range(n)]


def files_of(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_wal_segments_and_checkpoint_json_are_byte_identical(tmp_path):
    state = {"watermark": 7, "last_seq": 9, "last_offset": 90,
             "partitions": {"q1": 2}, "ref_versions": {"safety_levels": 3},
             "ref_fingerprints": {"safety_levels": "ab" * 20},
             "repair_events": {"safety_levels": [[3, [1, 2], 0.5]]}}
    got = {}
    for name, dur in (("repro", rdur), ("port", tdur)):
        d = tmp_path / name
        wal = dur.IntakeLog(str(d / "wal"), fsync="never",
                            segment_bytes=1 << 10)
        seqs = [wal.append_frame(10 * (i + 1), fr)
                for i, fr in enumerate(frames_of(30, k=20))]
        assert seqs == list(range(1, 31))
        wal.close()
        written = files_of(str(d / "wal"))
        wal = dur.IntakeLog(str(d / "wal"), fsync="never",
                            segment_bytes=1 << 10)
        wal.truncate(12)
        tail = wal.tail()
        wal.close()
        ck = dur.CheckpointStore(str(d / "ck"))
        ck.save(dict(state, watermark=3))
        ck.save(state)
        led = dur.FrameLedger()
        for s in range(1, 6):
            led.note_logged(s, 10 * s)
        led.mark_done([2, 3, 1, 5])
        got[name] = (written, files_of(str(d / "wal")),
                     files_of(str(d / "ck")), tail, ck.load(),
                     led.watermark(), led.backlog())
    r, t = got["repro"], got["port"]
    assert len(r[0]) > 3                     # rotated
    assert 0 < len(r[1]) < len(r[0])         # truncated to the watermark
    assert r[0] == t[0] and r[1] == t[1]     # WAL segments, byte for byte
    assert r[2] == t[2]                      # checkpoint and its .bak
    assert r[3:] == t[3:] == ((30, 300), state, 3, 2)


def test_torn_tail_is_truncated_alike(tmp_path):
    """Both packages open a log whose last record was torn mid-write (and
    one with a flipped byte mid-log): the same readable prefix, the same
    sequence continued, the same bytes on disk afterwards."""
    got = {}
    for name, dur in (("repro", rdur), ("port", tdur)):
        out = []
        for cut in ("tail", "middle"):
            d = str(tmp_path / name / cut)
            wal = dur.IntakeLog(d, fsync="never")
            for i, fr in enumerate(frames_of(5)):
                wal.append_frame(i + 1, fr)
            wal.close()
            (seg,) = os.listdir(d)
            path = os.path.join(d, seg)
            with open(path, "r+b") as f:
                if cut == "tail":
                    f.truncate(os.path.getsize(path) - 3)
                else:
                    f.seek(os.path.getsize(path) // 2)
                    f.write(b"\xff")
            re = dur.IntakeLog(d, fsync="never")
            before = [(r.seq, r.offset, r.lines) for r in re.replay(0)]
            seq = re.append_frame(99, [b"new"])
            re.close()
            out.append((before, seq, files_of(d)))
        got[name] = out
    assert got["repro"] == got["port"]
    assert [len(x[0]) for x in got["port"]] == [4, 2]


def test_ref_fingerprints_agree():
    r, t = make_manager("repro"), make_manager("port")
    for name in RQ.PAPER_CARDINALITIES:
        assert rdur.ref_fingerprint(r.refstore[name]) == \
            tdur.ref_fingerprint(t.refstore[name]), name


# ---------------------------------------------------------------------------
# crash images across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["repro", "port"])
def test_crash_images_resume_exactly_once_under_both(tmp_path, writer):
    """Images of ``writer``'s durable feed resume under ``repro`` and under
    the port: zero rows lost, zero duplicated, equal rows by id — and
    equal to the writer's own uninterrupted store."""
    total, batch, rate = 600, 25, 1500.0
    d = tmp_path / "dur"
    mgr = make_manager(writer)
    h = mgr.submit(durable_plan(writer, mgr, d, total, batch, rate=rate,
                                checkpoint_interval_s=0.1,
                                fsync_interval_s=0.02))
    rng = random.Random(11)
    images = [str(tmp_path / f"img{i}") for i in range(2)]
    for img in images:
        time.sleep(rng.uniform(0.05, total / rate / 2))
        copy_crash_image(str(d), img)
    h.join(timeout=120)
    assert_exactly_once(h.storage, total)
    whole = rows_by_id(h.storage)
    for i, img in enumerate(images):
        res = resume_both(img, total, tmp_path, f"r{i}", batch=batch)
        r, t = (rows_by_id(res[p][0].storage) for p in ("repro", "port"))
        assert_same_rows(r, t)
        assert_same_rows(t, whole)
        # the same WAL tail replayed, the same suffix re-obtained
        for side in ("port", "repro"):
            assert res[side][1].records_in > 0
        assert res["port"][0].durability.replayed_records == \
            res["repro"][0].durability.replayed_records
        assert res["port"][1].records_in == res["repro"][1].records_in
        ck = tdur.CheckpointStore(str(tmp_path / f"r{i}-port")).load()
        assert ck["watermark"] == ck["last_seq"]


def test_crash_images_with_live_merging_resume_under_both(tmp_path):
    """The port's form of the live-merging test: images taken while the
    port's store merges segments (a synchronous merge right before each
    copy) resume under both packages to the same rows, exactly once."""
    total, batch = 600, 25
    d = tmp_path / "dur"
    kw = dict(batch=batch, segment_rows=50,
              checkpoint_interval_s=0.1, fsync_interval_s=0.02)

    def compact(core):
        return core.CompactionSpec(interval_s=0.05, budget_rows_s=500_000.0,
                                   yield_backlog_batches=1e9, merge_fanin=3,
                                   level_target_rows=100_000)

    mgr = make_manager("port")
    h = mgr.submit(durable_plan("port", mgr, d, total, rate=1000.0,
                                compact=compact(tcore), **kw))
    rng = random.Random(13)
    images = [str(tmp_path / f"mimg{i}") for i in range(2)]
    for img in images:
        time.sleep(rng.uniform(0.1, 0.25))
        h.compaction.merge_now(min_run=2)
        copy_crash_image(str(d), img)
    h.join(timeout=120)
    assert_exactly_once(h.storage, total)
    assert h.stats.compaction.merges > 0
    assert any(lv > 0 for lv in h.storage.level_histogram())
    for i, img in enumerate(images):
        out = {}
        for pkg, core in (("repro", rcore), ("port", tcore)):
            mine = str(tmp_path / f"m{i}-{pkg}")
            shutil.copytree(img, mine)
            m2 = make_manager(pkg)
            h2 = m2.resume(durable_plan(pkg, m2, d, total,
                                        compact=compact(core), **kw),
                           durable_dir=mine)
            assert h2.durability.recovered
            h2.join(timeout=120)
            assert_exactly_once(h2.storage, total)
            assert h2.storage.segment_count >= 1
            out[pkg] = rows_by_id(h2.storage)
        assert_same_rows(out["repro"], out["port"])


def test_stop_mid_feed_then_resume_completes_stream(tmp_path):
    """A port feed stopped mid-stream is completed exactly once by a fresh
    port manager, and by ``repro`` from a copy of the same directory."""
    total, batch = 800, 25
    d = tmp_path / "dur"
    mgr = make_manager("port")
    h = mgr.submit(durable_plan("port", mgr, d, total, batch, rate=2000.0,
                                checkpoint_interval_s=0.1,
                                fsync_interval_s=0.01))
    time.sleep(0.15)
    h.stop()
    h.join(timeout=120)
    assert 0 < h.stats.records_in <= total
    res = resume_both(str(d), total, tmp_path, "stopped", batch=batch)
    assert_same_rows(rows_by_id(res["repro"][0].storage),
                     rows_by_id(res["port"][0].storage))


# ---------------------------------------------------------------------------
# repair lineage across a restart
# ---------------------------------------------------------------------------

def q1_durable(pkg, mgr, d, total):
    core, q, _ = PKGS[pkg]
    return (core.pipeline(core.SyntheticAdapter(total=total, frame_size=50,
                                                seed=3), "lin")
            .parse(batch_size=50).options(num_partitions=2)
            .enrich(q.Q1)
            .store(durable=core.DurableSpec(dir=str(d)),
                   refresh=core.RepairSpec())
            .compile(mgr.refstore))


@pytest.mark.parametrize("writer,resumer", [("repro", "port"),
                                            ("port", "repro"),
                                            ("port", "port")])
def test_resume_trusts_lineage_when_fingerprints_match(tmp_path, writer,
                                                       resumer):
    """The checkpoint of one package carries ref fingerprints and the
    repair journal the other trusts: resuming a converged feed under the
    same rebuilt tables repairs nothing."""
    d = tmp_path / "dur"
    mgr = make_manager(writer)
    mgr.submit(q1_durable(writer, mgr, d, 400)).join(timeout=120)
    ck = json.load(open(d / "CHECKPOINT.json"))
    assert "ref_fingerprints" in ck and "repair_events" in ck
    m2 = make_manager(resumer)
    h2 = m2.resume(q1_durable(resumer, m2, d, 400))
    stats = h2.join(timeout=120)
    assert_exactly_once(h2.storage, 400)
    assert stats.repaired_rows == 0


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_port_resume_rescans_on_fingerprint_mismatch(tmp_path, writer):
    """Changed tables across the restart: the port degrades to a full
    re-scan and converges to the new table (never silently current)."""
    d = tmp_path / "dur"
    mgr = make_manager(writer)
    mgr.submit(q1_durable(writer, mgr, d, 400)).join(timeout=120)
    m2 = make_manager("port")
    t = m2.refstore["safety_levels"]
    snap = t.snapshot()
    keys = np.asarray(snap.arrays["key"][:snap.size][:50], np.int64)
    t.upsert(keys, safety_level=np.full(keys.size, 4, np.int32))
    h2 = m2.resume(q1_durable("port", m2, d, 400))
    stats = h2.join(timeout=120)
    assert_exactly_once(h2.storage, 400)
    assert stats.repair is not None and stats.repair.units_scanned > 0
    snap = t.snapshot()
    table = dict(zip(snap.arrays["key"][:snap.size].tolist(),
                     snap.arrays["safety_level"][:snap.size].tolist()))
    rows = rows_by_id(h2.storage)
    want = [table.get(int(c), -1) for c in rows["country"]]
    np.testing.assert_array_equal(rows["safety_level"], want)
