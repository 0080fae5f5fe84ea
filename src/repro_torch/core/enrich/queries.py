"""The paper's enrichment-UDF workload (§8 + appendix A-G), as composable
``EnrichUDF``s over the operators in ``ops.py``.

Each UDF splits into:
  * ``state_fn(refs) -> state`` — the *intermediate state* of §5.3 (the hash
    table / aggregate / top-k list a stateful SQL++ UDF builds from its
    reference datasets).  Model 2 re-evaluates this per batch, which is
    exactly how reference-data changes become visible during ingestion;
    Model 3 evaluates it once (fast but stale — "current w/o updates").
  * ``apply_fn(batch, state, refs) -> enriched columns`` — the per-record
    probe side.

Both are plain functions on tensors of one device; the predeploy cache
resolves each once per (batch shape x table capacities) and reference
snapshots are invocation *parameters*.

The seven UDFs and their operator mix match the paper:
  Q1 Safety Level          hash join
  Q2 Religious Population  group-by (sum)
  Q3 Largest Religions     order-by / top-3
  Q4 Nearby Monuments      spatial join (1.5 deg)
  Q5 Suspicious Names      hash join + 2 spatial joins + group-by + order-by
  Q6 Tweet Context         hash join + 5 spatial joins + 2 group-bys
  Q7 Worrisome Tweets      hash join + spatial join + group-by + time window
plus §4's UDF1 (stateless safety check) and UDF2 (SensitiveWords join).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import records
from repro_torch.core.enrich import ops
from repro_torch.core.refdata import KEY_SENTINEL, RefStore

Array = torch.Tensor

# dictionary domains (DESIGN.md §2: dense-dictionary join for small domains)
COUNTRY_DOMAIN = 50_000     # country_code key space of the reference tables
NUM_RELIGIONS = 64
NUM_FACILITY_TYPES = 16
NUM_ETHNICITIES = 32
NUM_DISTRICTS = 512         # covers the paper's 500 districts
US_CODE = 0
BOMB_HASH = records.hash64("bomb")
TWO_MONTHS = 62 * 24 * 3600

# paper cardinalities (appendix)
PAPER_CARDINALITIES = {
    "safety_levels": 50_000,
    "religious_populations": 50_000,
    "monuments": 50_000,
    "sensitive_words": 10_000,
    "religious_buildings": 10_000,
    "facilities": 50_000,
    "suspicious_names": 1_000_000,
    "district_areas": 500,
    "average_incomes": 500,
    "persons": 1_000_000,
    "attack_events": 5_000,
}


@dataclasses.dataclass(frozen=True)
class EnrichUDF:
    name: str
    ref_tables: Tuple[str, ...]
    state_fn: Optional[Callable]   # refs -> state (None = stateless probe)
    apply_fn: Callable             # (batch, state, refs) -> enriched cols
    operators: str                 # paper's operator mix, for reports
    # non-empty for fused UDFs (built by ``chain``/``then``): the original
    # single-stage UDFs, in application order.  The computing runner uses
    # this to build/refresh intermediate state per stage (Model-2 semantics
    # per stage) and to attribute per-stage ComputingStats, while the apply
    # side stays ONE predeployed executable for the whole chain.
    stages: Tuple["EnrichUDF", ...] = ()
    # (ref table, batch column) pairs declaring that the UDF probes the
    # table's PRIMARY KEYS with that batch column (Q1: safety_levels keys
    # ARE country codes).  Lets the repair scheduler (core/repair.py)
    # refine coarse version-staleness with a dirty-key probe: a stored
    # segment none of whose rows touch an upserted key needs no repair.
    # Tables without a declared pair fall back to coarse version matching.
    repair_keys: Tuple[Tuple[str, str], ...] = ()

    @property
    def stateless(self) -> bool:
        return not self.ref_tables

    def build_state(self, refs: Dict[str, Dict[str, Array]]):
        if self.state_fn is None:
            return ()
        return self.state_fn(refs)

    def __call__(self, batch, state, refs):
        return self.apply_fn(batch, state, refs)

    def then(self, other: "EnrichUDF",
             name: Optional[str] = None) -> "EnrichUDF":
        """Left-to-right composition: ``a.then(b)`` applies ``a`` first and
        ``b`` second (``b`` sees ``a``'s output columns, SQL++ LET-style) —
        fused into ONE predeployed apply per batch with the union of both
        ref tables.  Flattens nested compositions so
        ``q1.then(q2).then(q3)`` is a flat three-stage chain."""
        mine = self.stages or (self,)
        theirs = other.stages or (other,)
        return chain(name or f"{self.name}>{other.name}", *mine, *theirs)


def _valid(table: Dict[str, Array]) -> Array:
    return table["key"] != KEY_SENTINEL


def _latlon(table: Dict[str, Array]) -> Array:
    return torch.stack([table["lat"], table["lon"]], dim=1)


# ---------------------------------------------------------------------------
# §4 UDF 1 — stateless US safety check
# ---------------------------------------------------------------------------

def _udf1_apply(batch, state, refs):
    has_bomb = torch.any(batch["text_tokens"] == BOMB_HASH, dim=1)
    red = (batch["country"] == US_CODE) & has_bomb
    return {"safety_check_flag": red.to(torch.int32)}   # 1=Red 0=Green


UDF1 = EnrichUDF("udf1_us_safety_check", (), None, _udf1_apply, "stateless")


# ---------------------------------------------------------------------------
# §4 UDF 2 — SensitiveWords join (the paper's running stateful example)
# ---------------------------------------------------------------------------

def _udf2_apply(batch, state, refs):
    sw = refs["sensitive_words"]
    red = ops.country_keyword_match(
        batch["text_tokens"], batch["country"].to(torch.int64),
        sw["country"].to(torch.int64), sw["word"], _valid(sw))
    return {"safety_check_flag": red.to(torch.int32)}


UDF2 = EnrichUDF("udf2_tweet_safety_check", ("sensitive_words",),
                 None, _udf2_apply, "hash join + contains")


# ---------------------------------------------------------------------------
# Q1 — Safety Level (hash join on country)
# ---------------------------------------------------------------------------

def _q1_apply(batch, state, refs):
    t = refs["safety_levels"]
    idx, found = ops.sorted_join(batch["country"].to(torch.int64),
                                 t["key"])
    lvl = ops.gather_col(t["safety_level"], idx, found, fill=-1)
    return {"safety_level": lvl}


Q1 = EnrichUDF("q1_safety_level", ("safety_levels",), None, _q1_apply,
               "hash join",
               repair_keys=(("safety_levels", "country"),))


# ---------------------------------------------------------------------------
# Q2 — Religious Population (group-by sum, then probe)
# ---------------------------------------------------------------------------

def _q2_state(refs):
    t = refs["religious_populations"]
    return ops.segment_sum(t["population"].to(torch.int64), t["country"],
                           COUNTRY_DOMAIN, _valid(t))


def _q2_apply(batch, state, refs):
    return {"religious_population":
            ops.take(state, batch["country"])}


Q2 = EnrichUDF("q2_religious_population", ("religious_populations",),
               _q2_state, _q2_apply, "group-by")


# ---------------------------------------------------------------------------
# Q3 — Largest Religions (per-country top-3)
# ---------------------------------------------------------------------------

def _q3_state(refs):
    t = refs["religious_populations"]
    top_rel, _ = ops.segment_topk(t["population"], t["country"],
                                  t["religion"], COUNTRY_DOMAIN, 3,
                                  _valid(t))
    return top_rel                                        # (C, 3) int32


def _q3_apply(batch, state, refs):
    return {"largest_religions":
            ops.take(state, batch["country"])}            # (B, 3)


Q3 = EnrichUDF("q3_largest_religions", ("religious_populations",),
               _q3_state, _q3_apply, "order-by/top-k")


# ---------------------------------------------------------------------------
# Q4 — Nearby Monuments (spatial join, radius 1.5 deg, up to 8 returned)
# ---------------------------------------------------------------------------

Q4_RADIUS, Q4_K = 1.5, 8


def _q4_apply(batch, state, refs):
    t = refs["monuments"]
    pts = torch.stack([batch["lat"], batch["lon"]], dim=1)
    idx, _, count = ops.radius_topk(pts, _latlon(t), Q4_RADIUS, Q4_K,
                                    _valid(t))
    ids = torch.where(idx >= 0, ops.take(t["key"], idx), -1)
    return {"nearby_monuments": ids, "nearby_monument_count": count}


Q4 = EnrichUDF("q4_nearby_monuments", ("monuments",), None, _q4_apply,
               "spatial join")


# ---------------------------------------------------------------------------
# Q5 — Suspicious Names (join + 2 spatial + group-by + order-by)
# ---------------------------------------------------------------------------

Q5_RADIUS, Q5_K = 3.0, 3


def _q5_apply(batch, state, refs):
    fac, rb, sn = (refs["facilities"], refs["religious_buildings"],
                   refs["suspicious_names"])
    pts = torch.stack([batch["lat"], batch["lon"]], dim=1)
    fac_counts = ops.group_count_within_radius(
        pts, _latlon(fac), fac["ftype"], NUM_FACILITY_TYPES, Q5_RADIUS,
        _valid(fac))
    idx, _, _ = ops.radius_topk(pts, _latlon(rb), Q5_RADIUS, Q5_K,
                                _valid(rb))
    rb_ids = torch.where(idx >= 0, ops.take(rb["key"], idx), -1)
    rb_rel = torch.where(idx >= 0, ops.take(rb["religion"], idx), -1)
    jidx, jfound = ops.sorted_join(batch["user_name_hash"], sn["key"])
    threat = ops.gather_col(sn["threat_level"], jidx, jfound, fill=-1)
    s_rel = ops.gather_col(sn["religion"], jidx, jfound, fill=-1)
    return {"nearby_facility_counts": fac_counts,
            "nearby_religious_buildings": rb_ids,
            "nearby_building_religions": rb_rel,
            "suspect_threat_level": threat,
            "suspect_religion": s_rel}


Q5 = EnrichUDF("q5_suspicious_names",
               ("facilities", "religious_buildings", "suspicious_names"),
               None, _q5_apply,
               "hash join + 2x spatial join + group-by + order-by",
               repair_keys=(("suspicious_names", "user_name_hash"),))


# ---------------------------------------------------------------------------
# Q6 — Tweet Context (the heavy one: ref-ref spatial joins in the state)
# ---------------------------------------------------------------------------

def _q6_state(refs):
    """All tweet-independent work: assign facilities and persons to
    districts (two big spatial joins), aggregate counts — the paper's
    'expensive spatial joins between referenced datasets before enriching'
    (§8.3, Tweet Context).  Model 2 pays this per batch, so larger batches
    amortize it — reproducing Fig 26's Tweet Context curve."""
    fac, dst, per, inc = (refs["facilities"], refs["district_areas"],
                          refs["persons"], refs["average_incomes"])
    rects = torch.stack([dst["xmin"], dst["ymin"], dst["xmax"],
                         dst["ymax"]], dim=1)
    rvalid = _valid(dst)

    nd = rects.shape[0]          # static snapshot capacity, not NUM_DISTRICTS

    fidx, ffound = ops.point_in_rect(_latlon(fac), rects, rvalid)
    fac_seg = torch.where(ffound & _valid(fac),
                        fidx * NUM_FACILITY_TYPES + fac["ftype"],
                        nd * NUM_FACILITY_TYPES)
    fac_counts = ops.segment_count(
        fac_seg, nd * NUM_FACILITY_TYPES + 1
    )[:-1].reshape(nd, NUM_FACILITY_TYPES)

    pidx, pfound = ops.point_in_rect(_latlon(per), rects, rvalid)
    eth_seg = torch.where(pfound & _valid(per),
                        pidx * NUM_ETHNICITIES + per["ethnicity"],
                        nd * NUM_ETHNICITIES)
    eth_counts = ops.segment_count(
        eth_seg, nd * NUM_ETHNICITIES + 1
    )[:-1].reshape(nd, NUM_ETHNICITIES)

    # income by district position (align incomes to the district snapshot)
    iidx, ifound = ops.sorted_join(dst["key"], inc["key"])
    income = ops.gather_col(inc["income"], iidx, ifound, fill=0.0)

    return {"rects": rects, "rvalid": rvalid, "fac_counts": fac_counts,
            "eth_counts": eth_counts, "income": income}


def _q6_apply(batch, state, refs):
    pts = torch.stack([batch["lat"], batch["lon"]], dim=1)
    didx, dfound = ops.point_in_rect(pts, state["rects"], state["rvalid"])
    income = torch.where(dfound, ops.take(state["income"], didx), 0.0)
    fac = torch.where(dfound[:, None], ops.take(state["fac_counts"], didx),
                      0)
    eth = torch.where(dfound[:, None], ops.take(state["eth_counts"], didx),
                      0)
    return {"district": didx, "area_avg_income": income,
            "area_facility_counts": fac, "area_ethnicity_dist": eth}


Q6 = EnrichUDF("q6_tweet_context",
               ("facilities", "district_areas", "persons",
                "average_incomes"),
               _q6_state, _q6_apply,
               "hash join + 5x spatial join + 2x group-by")


# ---------------------------------------------------------------------------
# Q7 — Worrisome Tweets (spatial + group-by + 2-month time window)
# ---------------------------------------------------------------------------

Q7_RADIUS, Q7_K = 3.0, 3


def _q7_apply(batch, state, refs):
    rb, ev = refs["religious_buildings"], refs["attack_events"]
    pts = torch.stack([batch["lat"], batch["lon"]], dim=1)
    idx, _, _ = ops.radius_topk(pts, _latlon(rb), Q7_RADIUS, Q7_K,
                                _valid(rb))
    rels = torch.where(idx >= 0, ops.take(rb["religion"], idx),
                       -1)                                 # (B, K)
    counts = ops.time_window_count_by_group(
        batch["created_at"], ev["time"], ev["religion"], rels, TWO_MONTHS,
        _valid(ev))
    counts = torch.where(rels >= 0, counts, 0)
    return {"nearby_religions": rels, "religion_attack_counts": counts}


Q7 = EnrichUDF("q7_worrisome_tweets",
               ("religious_buildings", "attack_events"), None, _q7_apply,
               "hash join + spatial join + group-by + time window")


# ---------------------------------------------------------------------------
# UDF composition + the LM data-plane UDF
# ---------------------------------------------------------------------------

def chain(name: str, *udfs: EnrichUDF) -> EnrichUDF:
    """Compose UDFs left-to-right into ONE fused UDF: states are built
    independently (per stage, so the runner can refresh/reuse them at stage
    granularity), outputs merged; later UDFs see earlier outputs in the
    batch (SQL++ LET-style).  The fused ``apply_fn`` runs the whole chain in
    a single predeployed apply — one invocation per batch instead of one
    per stage.  Nested chains flatten."""
    flat: Tuple[EnrichUDF, ...] = tuple(
        s for u in udfs for s in (u.stages or (u,)))
    tables = tuple(dict.fromkeys(t for u in flat for t in u.ref_tables))
    has_state = any(u.state_fn is not None for u in flat)

    def state_fn(refs):
        return tuple(u.state_fn(refs) if u.state_fn is not None else ()
                     for u in flat)

    def apply_fn(batch, state, refs):
        out = {}
        cur = dict(batch)
        for u, s in zip(flat, state):
            res = u.apply_fn(cur, s, refs)
            out.update(res)
            cur.update(res)
        return out

    ops_mix = " | ".join(u.operators for u in flat)
    rkeys = tuple(dict.fromkeys(
        pair for u in flat for pair in u.repair_keys))
    return EnrichUDF(name, tables, state_fn if has_state else None,
                     apply_fn if has_state else
                     (lambda b, s, r: apply_fn(b, ((),) * len(flat), r)),
                     ops_mix, stages=flat, repair_keys=rkeys)


def make_filter(name: str, pred: Callable[[Dict[str, Array]], Array]
                ) -> EnrichUDF:
    """A filter stage as a stateless UDF: rows where ``pred(batch)`` is
    False have their ``valid`` flag cleared, so every downstream sink (the
    storage job, tee'd consumers, the LM data plane) drops them.  Because
    it is an ``EnrichUDF`` it fuses into the chain's single predeployed
    apply — a declarative WHERE pushed into ingestion, not a host-side
    post-pass.  ``pred`` sees enriched columns of earlier stages."""
    def apply_fn(batch, state, refs):
        keep = pred(batch)
        return {"valid": batch["valid"] & keep.to(torch.bool)}

    return EnrichUDF(name, (), None, apply_fn, "filter")


LM_RESERVED = 16


def make_lm_tokenize(vocab_size: int) -> EnrichUDF:
    """Fold hashed text tokens into LM vocab ids (data/tokenizer.py shares
    this convention); emits (B, T) 'lm_tokens' with 0 = pad."""
    def apply_fn(batch, state, refs):
        toks = batch["text_tokens"]
        ids = toks % (vocab_size - LM_RESERVED) + LM_RESERVED
        ids = torch.where(toks == 0, 0, ids)
        return {"lm_tokens": ids.to(torch.int32)}

    return EnrichUDF(f"lm_tokenize_{vocab_size}", (), None, apply_fn,
                     "stateless tokenize")


ALL_UDFS: Dict[str, EnrichUDF] = {
    u.name: u for u in (UDF1, UDF2, Q1, Q2, Q3, Q4, Q5, Q6, Q7)}
SHORT_NAMES = {"udf1": UDF1, "udf2": UDF2, "q1": Q1, "q2": Q2, "q3": Q3,
               "q4": Q4, "q5": Q5, "q6": Q6, "q7": Q7}


def get_udf(name: str) -> EnrichUDF:
    if name in SHORT_NAMES:
        return SHORT_NAMES[name]
    return ALL_UDFS[name]


# ---------------------------------------------------------------------------
# synthetic reference datasets at paper cardinalities (scalable)
# ---------------------------------------------------------------------------

def make_reference_tables(store: RefStore, scale: float = 1.0,
                          seed: int = 7,
                          scale_overrides: Optional[Dict[str, float]] = None,
                          headroom: int = 1024) -> None:
    """Create + populate every reference table the UDF workload needs.
    ``scale`` multiplies the paper cardinality (scale_overrides per table —
    §8.3 scales only the three simple-UDF tables by 100x).  ``headroom``
    leaves spare capacity for mid-ingestion UPSERTs."""
    rng = np.random.default_rng(seed)
    n = {}
    for name, card in PAPER_CARDINALITIES.items():
        s = (scale_overrides or {}).get(name, scale)
        n[name] = max(4, int(card * s))

    t = store.create("safety_levels", n["safety_levels"] + headroom,
                     {"safety_level": np.int32})
    keys = np.arange(n["safety_levels"], dtype=np.int64)
    t.upsert(keys, safety_level=rng.integers(
        0, 5, n["safety_levels"]).astype(np.int32))

    t = store.create("religious_populations",
                     n["religious_populations"] + headroom,
                     {"country": np.int32, "religion": np.int32,
                      "population": np.int32})
    m = n["religious_populations"]
    t.upsert(np.arange(m, dtype=np.int64),
             country=rng.integers(0, records.NUM_COUNTRIES, m
                                  ).astype(np.int32),
             religion=rng.integers(0, NUM_RELIGIONS, m).astype(np.int32),
             population=rng.integers(1_000, 10_000_000, m).astype(np.int32))

    t = store.create("monuments", n["monuments"] + headroom,
                     {"lat": np.float32, "lon": np.float32})
    m = n["monuments"]
    t.upsert(np.arange(m, dtype=np.int64),
             lat=rng.uniform(-60, 60, m).astype(np.float32),
             lon=rng.uniform(-180, 180, m).astype(np.float32))

    t = store.create("sensitive_words", n["sensitive_words"] + headroom,
                     {"country": np.int32, "word": np.int64})
    m = n["sensitive_words"]
    words = [records.hash64(w) for w in
             rng.choice(records._WORDS, m)]
    t.upsert(np.arange(m, dtype=np.int64),
             country=rng.integers(0, records.NUM_COUNTRIES, m
                                  ).astype(np.int32),
             word=np.asarray(words, np.int64))

    t = store.create("religious_buildings",
                     n["religious_buildings"] + headroom,
                     {"lat": np.float32, "lon": np.float32,
                      "religion": np.int32})
    m = n["religious_buildings"]
    t.upsert(np.arange(m, dtype=np.int64),
             lat=rng.uniform(-60, 60, m).astype(np.float32),
             lon=rng.uniform(-180, 180, m).astype(np.float32),
             religion=rng.integers(0, NUM_RELIGIONS, m).astype(np.int32))

    t = store.create("facilities", n["facilities"] + headroom,
                     {"lat": np.float32, "lon": np.float32,
                      "ftype": np.int32})
    m = n["facilities"]
    t.upsert(np.arange(m, dtype=np.int64),
             lat=rng.uniform(-60, 60, m).astype(np.float32),
             lon=rng.uniform(-180, 180, m).astype(np.float32),
             ftype=rng.integers(0, NUM_FACILITY_TYPES, m).astype(np.int32))

    t = store.create("suspicious_names", n["suspicious_names"] + headroom,
                     {"religion": np.int32, "threat_level": np.int32})
    m = n["suspicious_names"]
    name_keys = np.asarray(
        [records.hash64(f"user{i}") for i in
         rng.choice(1_000_000, m, replace=False)], np.int64)
    t.upsert(name_keys,
             religion=rng.integers(0, NUM_RELIGIONS, m).astype(np.int32),
             threat_level=rng.integers(1, 11, m).astype(np.int32))

    t = store.create("district_areas", n["district_areas"] + headroom,
                     {"xmin": np.float32, "ymin": np.float32,
                      "xmax": np.float32, "ymax": np.float32})
    m = n["district_areas"]
    cx = rng.uniform(-58, 58, m).astype(np.float32)
    cy = rng.uniform(-170, 170, m).astype(np.float32)
    w = rng.uniform(1.0, 8.0, m).astype(np.float32)
    h = rng.uniform(1.0, 8.0, m).astype(np.float32)
    t.upsert(np.arange(m, dtype=np.int64),
             xmin=cx - w, ymin=cy - h, xmax=cx + w, ymax=cy + h)

    t = store.create("average_incomes", n["average_incomes"] + headroom,
                     {"income": np.float32})
    m = n["average_incomes"]
    t.upsert(np.arange(m, dtype=np.int64),
             income=rng.uniform(20_000, 120_000, m).astype(np.float32))

    t = store.create("persons", n["persons"] + headroom,
                     {"lat": np.float32, "lon": np.float32,
                      "ethnicity": np.int32})
    m = n["persons"]
    t.upsert(np.arange(m, dtype=np.int64),
             lat=rng.uniform(-60, 60, m).astype(np.float32),
             lon=rng.uniform(-180, 180, m).astype(np.float32),
             ethnicity=rng.integers(0, NUM_ETHNICITIES, m).astype(np.int32))

    t = store.create("attack_events", n["attack_events"] + headroom,
                     {"time": np.int64, "religion": np.int32})
    m = n["attack_events"]
    t.upsert(np.arange(m, dtype=np.int64),
             time=rng.integers(1_500_000_000, 1_600_000_000, m
                               ).astype(np.int64),
             religion=rng.integers(0, NUM_RELIGIONS, m).astype(np.int32))
