"""The LM data plane, a port of ``repro.train.data_feed``: an IDEA
ingestion *plan* whose computing jobs tokenize (and optionally
safety-filter) the incoming stream, with a tee sink that packs the
enriched records into dense (B, S) training batches:

    pipeline(adapter).parse(...).enrich(UDF2).enrich(tokenize)
        .filter(safe).tee(packer_sink)[.store(...)]

The safety UDF, the tokenizer and the filter fuse into one predeployed
apply per batch, on the manager's device; the filter clears ``valid``
for flagged records.  The SensitiveWords lexicon is reference data:
upserting a keyword mid-training changes which records enter the
training stream at the next batch (Model-2 freshness).  The sink gets the
enriched batch as numpy and packs it on the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core import FeedManager, SyntheticAdapter, pipeline
from repro_torch.core.enrich import queries as Q
from repro_torch.data.packing import StreamPacker


class FeedDataSource:
    """Iterator of packed LM batches, produced by a live IDEA feed."""

    def __init__(self, manager: FeedManager, vocab_size: int,
                 seq_len: int, batch_size: int,
                 total_records: int = 100_000,
                 frame_size: int = 256,
                 safety_filter: bool = False,
                 num_partitions: int = 2,
                 seed: int = 0,
                 queue_batches: int = 8,
                 store_enriched: bool = False):
        self.packer = StreamPacker(seq_len, batch_size)
        self._q: "queue.Queue[Optional[Dict]]" = queue.Queue(queue_batches)
        self._packer_lock = threading.Lock()  # lock-name: lm-packer
        self.filtered = 0                     # guarded-by: _packer_lock

        def sink(batch: Dict[str, np.ndarray]) -> None:
            with self._packer_lock:
                if safety_filter:
                    # red rows already have valid=False (filter stage); the
                    # flag column still flows for observability
                    self.filtered += int(
                        (batch["safety_check_flag"] != 0).sum())
                for i in np.where(batch["valid"])[0]:
                    ids = [int(t) for t in batch["lm_tokens"][i] if t != 0]
                    if not ids:
                        continue
                    out = self.packer.add(ids)
                    if out is not None:
                        self._q.put(out)

        p = (pipeline(SyntheticAdapter(total=total_records,
                                       frame_size=frame_size, seed=seed),
                      f"lm-data-{seed}")
             .parse(batch_size=frame_size)
             .options(num_partitions=num_partitions))
        if safety_filter:
            p.enrich(Q.UDF2)
        p.enrich(Q.make_lm_tokenize(vocab_size))
        if safety_filter:
            p.filter(lambda b: b["safety_check_flag"] == 0, name="safe_only")
        p.tee(sink, name="lm_data_plane")
        if store_enriched:
            p.store()
        self.handle = manager.submit(p)
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        try:
            self.handle.join()
            with self._packer_lock:
                out = self.packer.flush()
            if out is not None:
                self._q.put(out)
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def stop(self):
        self.handle.stop()

    def close(self, timeout: float = 120.0) -> None:
        """Stop the feed and drain what it still produces, so no sink stays
        blocked on the full queue; returns once the feed has ended."""
        self.stop()
        done = threading.Event()

        def drain():
            for _ in self:
                pass
            done.set()
        threading.Thread(target=drain, daemon=True).start()
        if not done.wait(timeout):
            raise TimeoutError(f"the LM feed did not end in {timeout} s")
