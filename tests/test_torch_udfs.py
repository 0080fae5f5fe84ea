"""All nine enrichment UDFs and a fused Q1 > Q2 > Q3 chain through both
packages: ``repro``'s ComputingRunner under ``dispatch_mode("reference")``
and the port's ComputingRunner on the CPU, on the same tweets and the
same scale-0.002 reference tables (built by ``repro``, carried across with
``refstore_from_numpy``).  Output columns must have equal dtypes, shapes
and values.

The spatial UDFs (Q4, Q5, Q7) are held to ``repro``'s ``reference`` path,
which computes d2 = |a|^2 + |b|^2 - 2ab; the port computes dx*dx + dy*dy.
The formulas differ by up to ~1e-2 in float32 at these coordinates, so
each test first asserts that no probe-reference pair lies within 0.05 of
the radius squared: then neither membership nor counts can differ."""

import numpy as np
import pytest
import torch

from repro.core import ComputingRunner, ComputingSpec, RefStore
from repro.core.enrich import ops as r_ops
from repro.core.enrich import queries as RQ
from repro.core.records import SyntheticTweets, parse_json_lines
from repro.kernels import dispatch_mode
from repro_torch.core import ComputingRunner as TRunner
from repro_torch.core import ComputingSpec as TSpec
from repro_torch.core.enrich import ops as t_ops
from repro_torch.core.enrich import queries as TQ
from repro_torch.core.records import SyntheticTweets as TSyntheticTweets
from repro_torch.core.records import parse_json_lines as t_parse
from repro_torch.core.refdata import RefStore as TRefStore
from repro_torch.core.refdata import refstore_from_numpy

SCALE = 0.002   # 50k-row tables -> 100 rows; persons/suspicious -> 2000
MARGIN = 0.05   # |d2 - r^2| every spatial pair must clear
SPATIAL = {"q4_nearby_monuments": (("monuments", 1.5),),
           "q5_suspicious_names": (("religious_buildings", 3.0),
                                   ("facilities", 3.0)),
           "q7_worrisome_tweets": (("religious_buildings", 3.0),)}


@pytest.fixture(scope="module")
def stores():
    s = RefStore()
    RQ.make_reference_tables(s, scale=SCALE, seed=7)
    tables = {name: s[name].snapshot().arrays
              for name in RQ.PAPER_CARDINALITIES}
    return s, refstore_from_numpy(tables)


@pytest.fixture(scope="module")
def tweets():
    return parse_json_lines(SyntheticTweets(seed=3).raw_lines(64))


def clear_of_radius(store, tweets, table, radius):
    """Smallest |d2 - r^2| over valid (tweet, reference) pairs, in float64."""
    a = store[table].snapshot().arrays
    ok = a["key"] != np.iinfo(np.int64).max
    dx = tweets["lat"][:, None].astype(np.float64) - a["lat"][ok][None]
    dy = tweets["lon"][:, None].astype(np.float64) - a["lon"][ok][None]
    return float(np.abs(dx * dx + dy * dy - radius * radius).min())


def run_both(stores, udf_name, batch, model="per_batch"):
    rstore, tstore = stores
    b = batch["id"].shape[0]
    with dispatch_mode("reference"):
        want = ComputingRunner(ComputingSpec(RQ.get_udf(udf_name), b, model),
                               rstore).run(dict(batch))
    got = TRunner(TSpec(TQ.get_udf(udf_name), b, model), tstore,
                  device="cpu").run(dict(batch))
    return want, got


def assert_same_columns(want, got):
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_port_builds_identical_reference_tables_and_tweets():
    """The data contract: the port's own make_reference_tables and
    SyntheticTweets give the reference's arrays bit for bit."""
    r = RefStore()
    RQ.make_reference_tables(r, scale=SCALE, seed=7)
    p = TRefStore()
    TQ.make_reference_tables(p, scale=SCALE, seed=7)
    for name in RQ.PAPER_CARDINALITIES:
        ra, pa = r[name].snapshot().arrays, p[name].snapshot().arrays
        assert set(ra) == set(pa)
        for k in ra:
            assert ra[k].dtype == pa[k].dtype
            np.testing.assert_array_equal(ra[k], pa[k])
    rb = parse_json_lines(SyntheticTweets(seed=5).raw_lines(50))
    pb = t_parse(TSyntheticTweets(seed=5).raw_lines(50))
    for k in rb:
        assert rb[k].dtype == pb[k].dtype
        np.testing.assert_array_equal(rb[k], pb[k])


@pytest.mark.parametrize("udf_name", sorted(RQ.SHORT_NAMES))
def test_udf_matches_reference(stores, tweets, udf_name):
    name = RQ.get_udf(udf_name).name
    for table, radius in SPATIAL.get(name, ()):
        assert clear_of_radius(stores[0], tweets, table, radius) > MARGIN
    want, got = run_both(stores, udf_name, tweets)
    assert_same_columns(want, got)


def test_fused_q1_q2_q3_chain_matches_reference(stores, tweets):
    rstore, tstore = stores
    b = tweets["id"].shape[0]
    rchain = RQ.Q1.then(RQ.Q2).then(RQ.Q3)
    tchain = TQ.Q1.then(TQ.Q2).then(TQ.Q3)
    with dispatch_mode("reference"):
        want = ComputingRunner(ComputingSpec(rchain, b), rstore
                               ).run(dict(tweets))
    runner = TRunner(TSpec(tchain, b), tstore, device="cpu")
    got = runner.run(dict(tweets))
    assert_same_columns(want, got)
    # one fused apply entry, one state entry per stateful stage
    by = runner.cache.by_name
    assert by[f"apply:{tchain.name}"] == {"compiles": 1, "invocations": 1}
    assert sum(1 for k in by if k.startswith("state:")) == 2


def test_filter_and_tokenize_stages_match_reference(stores, tweets):
    rstore, tstore = stores
    b = tweets["id"].shape[0]
    rudf = RQ.Q1.then(RQ.make_filter(
        "lvl", lambda x: x["safety_level"] >= 2)).then(
        RQ.make_lm_tokenize(4096))
    tudf = TQ.Q1.then(TQ.make_filter(
        "lvl", lambda x: x["safety_level"] >= 2)).then(
        TQ.make_lm_tokenize(4096))
    with dispatch_mode("reference"):
        want = ComputingRunner(ComputingSpec(rudf, b), rstore
                               ).run(dict(tweets))
    got = TRunner(TSpec(tudf, b), tstore, device="cpu").run(dict(tweets))
    assert_same_columns(want, got)
    assert 0 < got["valid"].sum() < b


@pytest.mark.parametrize("model", ["per_record", "stream"])
def test_computing_models_match_reference(stores, tweets, model):
    """Models 1 and 3 on a stateful UDF (Q6) and a probe (Q1)."""
    small = {k: v[:8] for k, v in tweets.items()}
    for udf_name in ("q1", "q6"):
        want, got = run_both(stores, udf_name, small, model)
        assert_same_columns(want, got)


def test_radius_topk_dist2_within_formula_tolerance(stores, tweets):
    """The op itself: idx and count exact; dist2 within 0.05, the gap
    between the reference path's |a|^2+|b|^2-2ab and the port's
    dx*dx+dy*dy at these coordinates."""
    assert clear_of_radius(stores[0], tweets, "monuments", 1.5) > MARGIN
    a = stores[0]["monuments"].snapshot().arrays
    valid = a["key"] != np.iinfo(np.int64).max
    refs = np.stack([a["lat"], a["lon"]], axis=1)
    pts = np.stack([tweets["lat"], tweets["lon"]], axis=1)
    wi, wd, wc = r_ops._radius_topk_ref(pts, refs, 1.5, 8, valid)
    gi, gd, gc = t_ops.radius_topk(torch.from_numpy(pts),
                                   torch.from_numpy(refs), 1.5, 8,
                                   torch.from_numpy(valid))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=0.05)
    assert (gc.numpy() > 0).any()
