"""Hash tokenizer: stable word -> id mapping into a fixed vocab.

The IDEA intake parser already hashes text tokens (records.hash64); the LM
data plane folds those hashes into [reserved, vocab) ids.  Reserved ids:
0=pad, 1=bos, 2=eos, 3..15 special.
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.records import hash64

PAD, BOS, EOS = 0, 1, 2
RESERVED = 16


class HashTokenizer:
    def __init__(self, vocab_size: int):
        assert vocab_size > RESERVED
        self.vocab_size = vocab_size

    def fold(self, token_hashes: np.ndarray) -> np.ndarray:
        """int64 hashes (0 = empty slot) -> vocab ids (0 = pad)."""
        ids = token_hashes % (self.vocab_size - RESERVED) + RESERVED
        return np.where(token_hashes == 0, PAD, ids).astype(np.int32)

    def encode(self, text: str) -> List[int]:
        return [int(self.fold(np.asarray([hash64(w)], np.int64))[0])
                for w in text.split()]
