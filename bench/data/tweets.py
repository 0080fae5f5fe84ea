"""The records and the reference table of the training cells, frozen here
so that the traffic does not change with the program.

A copy of the port's synthetic tweet stream (``core/records.py``:
``SyntheticTweets.raw_lines``, ``hash64``, the word list) and of the
SensitiveWords part of its table generator
(``core/enrich/queries.py::make_reference_tables``) at the paper's
cardinality.  Both the program and the reference read what these make.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Iterator, List

import numpy as np

TEXT_TOKENS = 16
NUM_COUNTRIES = 256
WORDS = [f"w{i}" for i in range(4096)] + ["bomb", "alert", "match", "storm"]
SENSITIVE_WORDS = 10_000     # the paper's SensitiveWords cardinality


@functools.lru_cache(maxsize=1 << 16)
def hash64(s: str) -> int:
    """63-bit FNV-1a of ``s``'s UTF-8 bytes."""
    h = 14695981039346656037
    for b in s.encode():
        h = (h ^ b) * 1099511628211 & 0x7FFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


class TweetStream:
    """JSON-lines tweets with ids 0, 1, 2, ... in frames of
    ``frame_size``; the same seed and frame size give the same bytes."""

    def __init__(self, seed: int, frame_size: int):
        self.frame_size = frame_size
        self._rng = np.random.default_rng(seed)
        self._next_id = 0

    def raw_lines(self, n: int) -> List[bytes]:
        rng = self._rng
        ids = np.arange(self._next_id, self._next_id + n)
        self._next_id += n
        countries = rng.integers(0, NUM_COUNTRIES, n)
        lats = rng.uniform(-60, 60, n)
        lons = rng.uniform(-180, 180, n)
        ts = rng.integers(1_500_000_000, 1_600_000_000, n)
        recs = []
        for i in range(n):
            nwords = int(rng.integers(4, TEXT_TOKENS))
            words = rng.choice(len(WORDS), nwords)
            recs.append(json.dumps({
                "id": int(ids[i]),
                "country": int(countries[i]),
                "lat": round(float(lats[i]), 4),
                "lon": round(float(lons[i]), 4),
                "created_at": int(ts[i]),
                "user": f"user{int(rng.integers(0, 1_000_000))}",
                "text": " ".join(WORDS[w] for w in words),
            }).encode())
        return recs

    def frames(self, total: int) -> Iterator[List[bytes]]:
        left = total
        while left > 0:
            n = min(self.frame_size, left)
            yield self.raw_lines(n)
            left -= n


def sensitive_words(seed: int, n: int = SENSITIVE_WORDS
                    ) -> Dict[str, np.ndarray]:
    """The SensitiveWords rows: key, country, word hash."""
    rng = np.random.default_rng(seed)
    words = rng.choice(WORDS, n)
    return {"key": np.arange(n, dtype=np.int64),
            "country": rng.integers(0, NUM_COUNTRIES, n).astype(np.int32),
            "word": np.asarray([hash64(str(w)) for w in words], np.int64)}
