"""An admission's first token from prefill's own logits, for every family
at smoke sizes on the CPU: ``api.prefill(..., last=)`` gives the logits of
``api.apply`` at token position ``last`` (and, without ``last``, at the
final row), and ``ServingEngine`` admits without calling ``apply`` yet
serves the tokens of an engine that takes its first token as the argmax
of ``apply`` at the true last prompt position."""

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import api
from repro_torch.serve import Request, ServingEngine

FAMILY_ARCH = {
    "dense": "deepseek-coder-33b",
    "moe": "olmoe-1b-7b",
    "vlm": "internvl2-2b",
    "ssm": "mamba2-130m",
    "hybrid": "jamba-1.5-large-398b",
    "encdec": "whisper-medium",
}
BUCKET = 16
PROMPT_LENS = (5, 11, 20)           # each padded to the bucket
# ssm and hybrid prefill the exact prompt, whose chunked scan takes a
# length within one chunk or a whole number of them
SCAN_PROMPT_LENS = (5, 8, 16)


def _model(family):
    cfg = smoke_config(FAMILY_ARCH[family])
    assert cfg.family == family
    return cfg, api.init_params(cfg, torch.Generator().manual_seed(3))


def _frontend(cfg, b):
    if cfg.family not in ("vlm", "encdec"):
        return None
    g = torch.Generator().manual_seed(4)
    return torch.randn((b, cfg.num_frontend_tokens, cfg.d_model),
                       generator=g)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_prefill_logits_at_last_match_apply(family):
    cfg, params = _model(family)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(16, cfg.vocab_size, (2, BUCKET)).astype(np.int32))
    # row 0 a prompt of 11 padded to the bucket, row 1 the bucket's length
    tokens[0, 11:] = 0
    last = torch.tensor([10, BUCKET - 1])
    frontend = _frontend(cfg, 2)
    batch = {"tokens": tokens}
    if frontend is not None:
        batch["frontend"] = frontend
    with torch.no_grad():
        full, _ = api.apply(cfg, params, batch)
        _, at_last = api.prefill(cfg, params, tokens, frontend, last)
        _, at_end = api.prefill(cfg, params, tokens, frontend)
    assert at_last.dtype == at_end.dtype == torch.float32
    assert at_last.shape == at_end.shape == (2, cfg.vocab_size)
    want = full[torch.arange(2), last]
    torch.testing.assert_close(at_last, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(at_end, full[:, -1], rtol=1e-5, atol=1e-5)
    # the gather picks each row's own position
    assert not torch.allclose(at_last[0], full[0, -1], atol=1e-3)


def _parent_prefill(real_prefill, real_apply):
    """``api.prefill`` as the engine used it before its first token came
    from prefill: the cache of a prefill without ``last``, and the logits
    of a second, full ``apply`` at the true last prompt position, found
    from the prompt itself (its ids are 16 and up, its padding 0), not
    from the engine's ``last``."""
    def prefill(cfg, params, tokens, frontend=None, last=None):
        cache, _ = real_prefill(cfg, params, tokens, frontend)
        batch = {"tokens": tokens}
        if frontend is not None:
            batch["frontend"] = frontend
        full, _ = real_apply(cfg, params, batch)
        true_last = (tokens != 0).sum(dim=1) - 1
        return cache, full[torch.arange(tokens.shape[0]), true_last]
    return prefill


def _serve(cfg, params):
    eng = ServingEngine(cfg, params, slots=2, max_len=64,
                        prompt_bucket=BUCKET, device="cpu")
    rng = np.random.default_rng(2)
    lens = SCAN_PROMPT_LENS if eng.bucket == 1 else PROMPT_LENS
    reqs = [eng.submit(Request(rng.integers(16, cfg.vocab_size, n).tolist(),
                               max_new_tokens=4, stop_at_eos=False))
            for n in lens]
    with torch.no_grad():
        assert len(eng.run()) == len(reqs)
    return [r.tokens for r in reqs], eng


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_admission_runs_no_apply_and_serves_the_same_tokens(family,
                                                            monkeypatch):
    cfg, params = _model(family)
    real_prefill, real_apply = api.prefill, api.apply
    with monkeypatch.context() as m:
        m.setattr(api, "prefill", _parent_prefill(real_prefill, real_apply))
        want, _ = _serve(cfg, params)

    calls = []

    def counted(fn):
        def wrapped(*args, **kw):
            calls.append(fn)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(api, "apply", counted(real_apply))
    monkeypatch.setattr(api.module(cfg), "apply",
                        counted(api.module(cfg).apply))
    got, eng = _serve(cfg, params)
    assert calls == []
    assert eng.prefills == len(PROMPT_LENS)
    assert got == want
    assert all(len(t) == 4 for t in got)
