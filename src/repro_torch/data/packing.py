"""Sequence packing (a copy of ``repro.data.packing``, numpy only):
variable-length documents -> dense (B, S) batches with segment ids and
per-segment positions, so packed documents never attend to each other
(the packing-aware mask in models/layers.causal_mask).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.data.tokenizer import BOS, EOS


class StreamPacker:
    """Greedy first-fit packing of a document stream into fixed shapes.

    Emits batches {tokens, targets, segment_ids, positions, loss_mask}, all
    (B, S) int32.  targets are next-token; the final token of each document
    predicts EOS; padding has loss_mask 0 and segment_id 0.
    """

    def __init__(self, seq_len: int, batch_size: int):
        self.seq_len = seq_len
        self.batch_size = batch_size
        self._rows: List[List[Dict]] = []   # per-row list of docs

    def add(self, doc: List[int]) -> Optional[Dict[str, np.ndarray]]:
        """Add one document (list of token ids); returns a full batch when
        one becomes available."""
        doc = [BOS] + list(doc)[: self.seq_len - 2] + [EOS]
        for row in self._rows:
            used = sum(len(d["ids"]) for d in row)
            if used + len(doc) <= self.seq_len:
                row.append({"ids": doc})
                break
        else:
            self._rows.append([{"ids": doc}])
        if len(self._rows) > self.batch_size or (
                len(self._rows) == self.batch_size
                and self._row_full(self._rows[self.batch_size - 1])):
            return self._emit()
        return None

    def _row_full(self, row) -> bool:
        return sum(len(d["ids"]) for d in row) >= self.seq_len - 4

    def flush(self) -> Optional[Dict[str, np.ndarray]]:
        return self._emit() if self._rows else None

    def _emit(self) -> Dict[str, np.ndarray]:
        b, s = self.batch_size, self.seq_len
        rows, self._rows = self._rows[:b], self._rows[b:]
        tokens = np.zeros((b, s), np.int32)
        targets = np.zeros((b, s), np.int32)
        segment = np.zeros((b, s), np.int32)
        positions = np.zeros((b, s), np.int32)
        loss = np.zeros((b, s), np.float32)
        for i, row in enumerate(rows):
            cur = 0
            for seg, d in enumerate(row, start=1):
                ids = d["ids"]
                n = len(ids)
                tokens[i, cur:cur + n] = ids
                targets[i, cur:cur + n - 1] = ids[1:]
                targets[i, cur + n - 1] = EOS
                segment[i, cur:cur + n] = seg
                positions[i, cur:cur + n] = np.arange(n)
                loss[i, cur:cur + n] = 1.0
                cur += n
        return {"tokens": tokens, "targets": targets,
                "segment_ids": segment, "positions": positions,
                "loss_mask": loss}


def pack_stream(docs: Iterator[List[int]], seq_len: int, batch_size: int
                ) -> Iterator[Dict[str, np.ndarray]]:
    packer = StreamPacker(seq_len, batch_size)
    for doc in docs:
        out = packer.add(doc)
        if out is not None:
            yield out
    out = packer.flush()
    if out is not None:
        yield out
