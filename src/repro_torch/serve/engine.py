"""Slot-based continuous-batching serving engine (``repro.serve.engine``
on PyTorch).

A fixed pool of ``slots`` decode lanes shares one batched KV/SSD cache, a
tree of tensors allocated from ``api.cache_specs``.  Incoming requests
are prefilled one at a time (prompt lengths bucketed, as in ``repro``,
where the buckets bound the compiled prefill shapes) and spliced into a
free slot; the decode step always runs the full batch, and finished
slots are refilled between steps.

Bucketed prefill correctness: the prompt is right-padded to the bucket, the
slot's ``len`` is reset to the true prompt length, and the first token is
the argmax of prefill's own logits at the true last position (``last``):
causal attention keeps the padding after it out of that row, so it is the
row ``repro``'s engine takes from a second, full ``apply``.  Junk cache
rows beyond the true length are overwritten by the decode writes before
the causal mask can ever expose them (attention families).  SSM and
hybrid caches carry recurrent state, so those families prefill the exact
prompt (bucket 1).  The vlm family prefills its prompt after a zero
frontend of ``num_frontend_tokens`` patch embeddings, which count in
``len``.  The encdec family gets a zero frontend of
``num_frontend_tokens`` frames too, but as a separate encoder sequence:
``len`` counts the prompt only, and the encoder runs once, inside
``prefill``.

On the card every admission runs the flash kernel once in each attention
layer, in ``prefill`` (for encdec, in each encoder layer and in each
decoder layer's self- and cross-attention), and the float32 head over
one row.  An encdec decode step runs the flash kernel once in each
decoder layer, for the cross-attention.  The engine keeps the host-clock seconds of its
admissions (``prefill_s``: the prefill, the first-token read and the
splice together) and decode steps (``decode_s``); both end in a
device-to-host read of the chosen tokens, so they include the device's
work.

Given a ``core.obs`` ``Tracer`` (``tracer=``), each ``step`` records
program spans on it (``core/obs/trace.py``): ``serve.queue`` (a request's
wait from ``submit`` to the start of its admission), ``serve.admit``
with its children ``serve.prefill`` (``api.prefill`` and ``pad_cache``),
``serve.first_token`` (the argmax read of prefill's logits;
``positions`` is the logit rows the admission computes, 1) and
``serve.splice``, all under the request's ``rid``, and ``serve.decode``
(``live``: the slots in use).  The spans' device seconds are resolved
at the end of each step, after the step's last device-to-host read.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.obs.trace import Tracer, now_ns, span
from repro_torch.data.tokenizer import EOS
from repro_torch.models import api
from repro_torch.models.params import torch_dtype, tree_map


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    stop_at_eos: bool = True
    rid: int = dataclasses.field(default_factory=itertools.count().__next__)
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _splice(full, one, slot: int) -> None:
    """Write a one-request cache tree into batch slot ``slot`` of ``full``
    (every leaf has its batch on axis 1, after the layer or period
    axis)."""
    if isinstance(full, dict):
        for key, sub in full.items():
            _splice(sub, one[key], slot)
    else:
        full[:, slot] = one[:, 0].to(full.dtype)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_len: int = 256, prompt_bucket: int = 16,
                 device: DeviceLike = None, tracer: Optional[Tracer] = None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.bucket = prompt_bucket if cfg.family not in ("ssm", "hybrid") \
            else 1
        cshapes, _ = api.cache_specs(cfg, slots, max_len)
        self.cache = tree_map(lambda s: torch.zeros(
            s.shape, dtype=s.dtype, device=self.device), cshapes)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.tracer = tracer
        self._submitted: Dict[int, int] = {}   # rid -> now_ns(), traced

    # ----------------------------------------------------------------- admin
    def submit(self, req: Request) -> Request:
        if self.tracer is not None:
            self._submitted[req.rid] = now_ns()
        self.queue.append(req)
        return req

    def _insert(self, slot: int, req: Request) -> None:
        with span("serve.admit", rid=req.rid) as admit:
            if self.tracer is not None:
                q0 = self._submitted.pop(req.rid)
                self.tracer.record_span("serve.queue", q0, admit.t0 - q0,
                                        rid=req.rid)
            self._admit(slot, req)

    def _admit(self, slot: int, req: Request) -> None:
        t0 = time.perf_counter()
        true_len = len(req.prompt)
        blen = _round_up(true_len, self.bucket)
        prompt = np.zeros((1, blen), np.int32)
        prompt[0, :true_len] = req.prompt
        tokens = torch.from_numpy(prompt).to(self.device)
        frontend = None
        if self.cfg.family in ("vlm", "encdec"):
            frontend = torch.zeros(
                (1, self.cfg.num_frontend_tokens, self.cfg.d_model),
                dtype=torch_dtype(self.cfg.dtype), device=self.device)
        last = torch.full((1,), true_len - 1, dtype=torch.int64,
                          device=self.device)
        with span("serve.prefill"):
            cache1, logits = api.prefill(self.cfg, self.params, tokens,
                                         frontend, last)
            cache1 = api.pad_cache(self.cfg, cache1, self.max_len)
        self.prefills += 1
        with span("serve.first_token", positions=1):
            first = int(torch.argmax(logits[0]))
        nf = (self.cfg.num_frontend_tokens
              if self.cfg.family == "vlm" else 0)

        with span("serve.splice"):
            for key, full in self.cache.items():
                if key == "len":
                    full[slot] = true_len + nf
                else:   # splice the single-request cache into batch slot
                    _splice(full, cache1[key], slot)
        req.tokens.append(first)
        self.active[slot] = req
        self.prefill_s += time.perf_counter() - t0
        if req.stop_at_eos and first == EOS:
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self.active[slot]
        req.done = True
        self.completed.append(req)
        self.active[slot] = None

    # ------------------------------------------------------------------ run
    def step(self) -> bool:
        """Admit + one decode step.  Returns False when fully idle."""
        if self.tracer is None:
            return self._step()
        with self.tracer.active(self.device):
            try:
                return self._step()
            finally:    # after the step's last device-to-host read
                self.tracer.settle()

    def _step(self) -> bool:
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                self._insert(slot, self.queue.pop(0))
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return bool(self.queue)
        t0 = time.perf_counter()
        tok = np.zeros((self.slots, 1), np.int32)
        for s in live:
            tok[s, 0] = self.active[s].tokens[-1]
        with span("serve.decode", live=len(live)):
            logits, self.cache = api.decode_step(
                self.cfg, self.params, self.cache,
                torch.from_numpy(tok).to(self.device))
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.decode_steps += 1
        self.decode_s += time.perf_counter() - t0
        for s in live:
            req = self.active[s]
            t = int(nxt[s])
            req.tokens.append(t)
            if (req.stop_at_eos and t == EOS) or \
                    len(req.tokens) >= req.max_new_tokens or \
                    len(req.prompt) + len(req.tokens) >= self.max_len - 1:
                self._finish(s)
        return True

    def run(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if not self.step():
                break
        done, self.completed = self.completed, []
        return done
