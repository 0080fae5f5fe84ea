"""Tweet record schema, parser, and synthetic source.

The paper ingests JSON tweets (Figure 1: open datatype, required ``id`` +
``text``) and enriches them against reference datasets.  ADM's open records
become **fixed-width tensor records** (struct-of-arrays) here so every batch
has the same shapes and the predeployed (AOT-compiled) computing job is
reusable across batches:

    id              int64    primary key
    country         int32    dictionary code (the paper joins on country)
    lat, lon        float32  tweet location (spatial UDFs Q4-Q7)
    created_at      int64    seconds (Q7's 2-month attack window)
    user_name_hash  int64    hashed author name (Q5's suspicious-names join)
    text_tokens     int64[T] hashed text tokens, 0-padded (T=16)

Text adaptation (DESIGN.md §2): SQL++ ``contains(text, keyword)`` becomes a
membership test of the keyword's hash among the tweet's token hashes —
substring scan is pointer-chasing the TPU cannot do; tokenized-hash
membership is the vectorizable equivalent, computed with a (T, K) equality
matrix on the VPU.

The parser converts raw JSON-lines bytes -> tensor records; in the *new*
framework it runs inside the computing job (paper Fig 23), in the "current
feeds" baseline it runs on the single intake node (the Fig 24 bottleneck).
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Dict, Iterator, List

import numpy as np

try:                     # §Perf: orjson parses ~3-5x faster than stdlib —
    import orjson        # the parser is the paper's Fig-24 bottleneck
    _loads = orjson.loads
except ImportError:      # pragma: no cover
    _loads = json.loads

TEXT_TOKENS = 16
NUM_COUNTRIES = 256


@functools.lru_cache(maxsize=1 << 20)
def hash64(s: str) -> int:
    """Deterministic 63-bit FNV-1a (stable across processes, unlike
    ``hash()``; avoids the int64 sign bit).  Memoized: token vocabularies
    repeat heavily, and the per-byte python loop was 77% of parse time
    (§Perf — profiled before/after in EXPERIMENTS.md)."""
    h = 14695981039346656037
    for b in s.encode():
        h = (h ^ b) * 1099511628211 & 0x7FFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF   # empty string: mask the basis too


TWEET_SCHEMA: Dict[str, np.dtype] = {
    "id": np.dtype(np.int64),
    "country": np.dtype(np.int32),
    "lat": np.dtype(np.float32),
    "lon": np.dtype(np.float32),
    "created_at": np.dtype(np.int64),
    "user_name_hash": np.dtype(np.int64),
    "text_tokens": np.dtype((np.int64, (TEXT_TOKENS,))),
}


def empty_batch(n: int) -> Dict[str, np.ndarray]:
    out = {}
    for k, dt in TWEET_SCHEMA.items():
        if dt.subdtype is not None:
            base, shape = dt.subdtype
            out[k] = np.zeros((n,) + shape, base)
        else:
            out[k] = np.zeros((n,), dt)
    out["valid"] = np.zeros((n,), bool)
    return out


def batch_rows(batch: Dict[str, np.ndarray]) -> int:
    return int(batch["id"].shape[0])


# ---------------------------------------------------------------------------
# parsing (bytes -> tensor records)
# ---------------------------------------------------------------------------

def parse_json_lines(lines: List[bytes]) -> Dict[str, np.ndarray]:
    """The parser stage: JSON-lines -> struct-of-arrays."""
    n = len(lines)
    out = empty_batch(n)
    for i, raw in enumerate(lines):
        rec = _loads(raw)
        out["id"][i] = rec["id"]
        out["country"][i] = rec.get("country", 0)
        out["lat"][i] = rec.get("lat", 0.0)
        out["lon"][i] = rec.get("lon", 0.0)
        out["created_at"][i] = rec.get("created_at", 0)
        out["user_name_hash"][i] = hash64(rec.get("user", ""))
        toks = [hash64(w) for w in rec.get("text", "").split()[:TEXT_TOKENS]]
        out["text_tokens"][i, :len(toks)] = toks
        out["valid"][i] = True
    return out


def pad_batch(batch: Dict[str, np.ndarray], size: int
              ) -> Dict[str, np.ndarray]:
    """Pad to the compiled batch size (valid=False rows are inert in every
    UDF and dropped by the storage job).  Columns beyond the tweet schema —
    enriched outputs of an upstream stage group crossing an intermediate
    partition holder — are zero-padded at their own dtype/shape."""
    n = batch_rows(batch)
    if n == size:
        return batch
    assert n < size, (n, size)
    out = empty_batch(size)
    for k, v in batch.items():
        if k not in out:
            out[k] = np.zeros((size,) + v.shape[1:], v.dtype)
        out[k][:n] = v
    return out


def concat_batches(batches: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}


# ---------------------------------------------------------------------------
# synthetic source
# ---------------------------------------------------------------------------

_WORDS = [f"w{i}" for i in range(4096)] + ["bomb", "alert", "match", "storm"]


@dataclasses.dataclass
class SyntheticTweets:
    """Deterministic synthetic tweet stream (the experiments' data source).
    Emits raw JSON-lines bytes (so parsing cost is real, as in the paper) or
    pre-parsed tensor records."""
    seed: int = 0
    start_id: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._next_id = self.start_id

    def raw_lines(self, n: int) -> List[bytes]:
        recs = []
        rng = self._rng
        ids = np.arange(self._next_id, self._next_id + n)
        self._next_id += n
        countries = rng.integers(0, NUM_COUNTRIES, n)
        lats = rng.uniform(-60, 60, n)
        lons = rng.uniform(-180, 180, n)
        ts = rng.integers(1_500_000_000, 1_600_000_000, n)
        for i in range(n):
            nwords = int(rng.integers(4, TEXT_TOKENS))
            words = rng.choice(len(_WORDS), nwords)
            recs.append(json.dumps({
                "id": int(ids[i]),
                "country": int(countries[i]),
                "lat": round(float(lats[i]), 4),
                "lon": round(float(lons[i]), 4),
                "created_at": int(ts[i]),
                "user": f"user{int(rng.integers(0, 1_000_000))}",
                "text": " ".join(_WORDS[w] for w in words),
            }).encode())
        return recs

    def batches(self, total: int, batch: int) -> Iterator[List[bytes]]:
        left = total
        while left > 0:
            n = min(batch, left)
            yield self.raw_lines(n)
            left -= n
