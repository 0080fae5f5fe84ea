"""The LM data plane worked out again from the raw records, in plain
Python and NumPy: parse, UDF2 (the SensitiveWords join), the hash
tokenizer, the safe-only filter and the greedy packer.

The program's feed runs its partitions in parallel, so the order in which
whole enriched batches reach its sink is the program's: the harness
records the record ids of each batch as it arrives, and the reference
takes that order and nothing else from the program.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from bench.data.tweets import TEXT_TOKENS, TweetStream, hash64

PAD, BOS, EOS = 0, 1, 2
RESERVED = 16


class Packer:
    """Greedy first-fit packing into (batch, seq) rows: each document is
    BOS + its first seq - 2 tokens + EOS; a batch leaves once it has more
    rows than ``batch`` or its last row is within 4 tokens of full."""

    def __init__(self, seq: int, batch: int):
        self.seq, self.batch = seq, batch
        self.rows: List[List[List[int]]] = []

    def add(self, doc: Sequence[int]) -> Optional[Dict[str, np.ndarray]]:
        doc = [BOS] + list(doc)[: self.seq - 2] + [EOS]
        for row in self.rows:
            if sum(map(len, row)) + len(doc) <= self.seq:
                row.append(doc)
                break
        else:
            self.rows.append([doc])
        full = (len(self.rows) == self.batch and
                sum(map(len, self.rows[-1])) >= self.seq - 4)
        if len(self.rows) > self.batch or full:
            return self.emit()
        return None

    def emit(self) -> Dict[str, np.ndarray]:
        b, s = self.batch, self.seq
        rows, self.rows = self.rows[:b], self.rows[b:]
        out = {k: np.zeros((b, s), np.int32)
               for k in ("tokens", "targets", "segment_ids", "positions")}
        out["loss_mask"] = np.zeros((b, s), np.float32)
        for i, row in enumerate(rows):
            at = 0
            for seg, ids in enumerate(row, start=1):
                n = len(ids)
                out["tokens"][i, at:at + n] = ids
                out["targets"][i, at:at + n - 1] = ids[1:]
                out["targets"][i, at + n - 1] = EOS
                out["segment_ids"][i, at:at + n] = seg
                out["positions"][i, at:at + n] = np.arange(n)
                out["loss_mask"][i, at:at + n] = 1.0
                at += n
        return out


class Records:
    """The stream's records by id, regenerated frame by frame as far as
    asked."""

    def __init__(self, seed: int, frame_size: int, total: int):
        self._frames = TweetStream(seed, frame_size).frames(total)
        self._lines: List[bytes] = []

    def get(self, rid: int) -> Dict:
        while rid >= len(self._lines):
            self._lines.extend(next(self._frames))
        return json.loads(self._lines[rid])


def enrich(rec: Dict, flagged_words: Dict[int, set], vocab: int
           ) -> Optional[List[int]]:
    """The LM tokens of one record, or None when UDF2 flags it: one of its
    words (its first TEXT_TOKENS) is a sensitive word of its country."""
    words = rec["text"].split()[:TEXT_TOKENS]
    hashes = [hash64(w) for w in words]
    bad = flagged_words.get(int(rec["country"]), ())
    if any(h != 0 and h in bad for h in hashes):
        return None
    return [h % (vocab - RESERVED) + RESERVED for h in hashes if h != 0]


def sensitive_index(table: Dict[str, np.ndarray]) -> Dict[int, set]:
    out: Dict[int, set] = {}
    for c, w in zip(table["country"].tolist(), table["word"].tolist()):
        out.setdefault(int(c), set()).add(int(w))
    return out


def packed_batches(arrivals: Iterable[np.ndarray], records: Records,
                   table: Dict[str, np.ndarray], vocab: int, seq: int,
                   batch: int, want: int) -> List[Dict[str, np.ndarray]]:
    """The first ``want`` batches the packer emits when the records reach
    it in ``arrivals`` order (one id array per enriched batch)."""
    flagged = sensitive_index(table)
    packer = Packer(seq, batch)
    out: List[Dict[str, np.ndarray]] = []
    for ids in arrivals:
        for rid in ids.tolist():
            doc = enrich(records.get(int(rid)), flagged, vocab)
            if not doc:
                continue
            b = packer.add(doc)
            if b is not None:
                out.append(b)
                if len(out) == want:
                    return out
    return out


def mismatches(program: Dict[str, np.ndarray],
               reference: Dict[str, np.ndarray]) -> int:
    """Positions where any field of two packed batches differs."""
    bad = np.zeros(reference["tokens"].shape, bool)
    for k, ref in reference.items():
        got = np.asarray(program[k])
        if got.shape != ref.shape:
            return int(ref.size)
        bad |= got != ref
    return int(bad.sum())
