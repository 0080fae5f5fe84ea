"""Independent streams from one ``--seed``: weights, records, prompts and
the check's sample each draw from their own, so adding a draw to one
leaves the others as they were."""

from __future__ import annotations

import zlib

import numpy as np


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for stream ``name`` of run seed ``seed`` (any whole
    number that fits in 64 bits, negative too)."""
    words = [int(seed) & 0xFFFFFFFFFFFFFFFF, zlib.crc32(name.encode())]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, name))
