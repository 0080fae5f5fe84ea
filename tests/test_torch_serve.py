"""The port's serving engine on the CPU against ``repro``'s: the same
parameters (carried across by ``params_from_numpy``) and the same requests
give the same token lists, in test_serve.py's three scenarios for the
dense arch (naive generation, continuous refill, bucketed prefill), and
its first for the moe, ssm, vlm, hybrid and encdec families."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import save as j_save
from repro.configs import smoke_config as j_smoke_config
from repro.models import api as japi
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.launch import serve as t_launch
from repro_torch.models import api as tapi
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

ARCH = "deepseek-coder-33b"


def _models(arch):
    jcfg, tcfg = j_smoke_config(arch), t_smoke_config(arch)
    jp = japi.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return _models(ARCH)


def _serve(models, prompts, max_new, **kw):
    """The same requests through both engines: (repro's, the port's)
    token lists and engines."""
    jcfg, tcfg, jp, tp = models
    je = JEngine(jcfg, jp, **kw)
    te = TEngine(tcfg, tp, device="cpu", **kw)
    jr = [je.submit(JRequest(list(p), max_new_tokens=max_new,
                             stop_at_eos=False)) for p in prompts]
    tr = [te.submit(TRequest(list(p), max_new_tokens=max_new,
                             stop_at_eos=False)) for p in prompts]
    assert len(je.run()) == len(te.run()) == len(prompts)
    return [r.tokens for r in jr], [r.tokens for r in tr], je, te


def _greedy_reference(cfg, params, prompt, n):
    """test_serve.py's naive single-request generation, on the port (the
    vlm family's zero frontend is prefill's default)."""
    cache, logits = tapi.prefill(cfg, params,
                                 torch.tensor([prompt], dtype=torch.int32))
    cache = tapi.pad_cache(cfg, cache, 128)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(n - 1):
        logits, cache = tapi.decode_step(
            cfg, params, cache, torch.tensor([[out[-1]]], dtype=torch.int32))
        out.append(int(torch.argmax(logits[0])))
    return out


def test_engine_matches_repro_and_naive_generation(models):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(16, models[0].vocab_size, 8).tolist()
               for _ in range(5)]
    want, got, je, te = _serve(models, prompts, 6, slots=2, max_len=128)
    assert got == want
    assert te.decode_steps == je.decode_steps
    assert te.prefills == je.prefills == 5
    for toks, prompt in zip(got, prompts):
        assert toks == _greedy_reference(models[1], models[3], prompt, 6)


# test_serve.py:32's scenario for the other families: moe (bucketed
# prefill whose padding takes expert capacity), ssm and hybrid (exact-length
# prefill, recurrent caches, the hybrid's nested "ssm" cache spliced into
# its slot), vlm (the zero frontend, counted in the cache's len), encdec
# (the zero frames, not counted in len; cross keys and values spliced)
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-130m",
                                  "internvl2-2b", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_engine_matches_repro_for_each_family(arch):
    models = _models(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(16, models[0].vocab_size, 8).tolist()
               for _ in range(5)]
    want, got, je, te = _serve(models, prompts, 6, slots=2, max_len=128)
    assert got == want
    assert te.bucket == je.bucket
    assert te.decode_steps == je.decode_steps
    np.testing.assert_array_equal(te.cache["len"].numpy(),
                                  np.asarray(je.cache["len"]))
    for toks, prompt in zip(got, prompts):
        assert toks == _greedy_reference(models[1], models[3], prompt, 6)


def test_engine_continuous_refill_matches_repro(models):
    prompts = [[20 + i, 21, 22, 23] for i in range(6)]
    want, got, je, te = _serve(models, prompts, 3, slots=2, max_len=64)
    assert got == want
    assert all(len(t) == 3 for t in got)
    assert 6 <= te.decode_steps == je.decode_steps <= 14


def test_engine_bucketed_prefill_matches_repro(models):
    want, got, _, te = _serve(models, [[17, 18, 19]], 5, slots=1,
                              max_len=64, prompt_bucket=16)
    assert got == want
    assert got[0] == _greedy_reference(models[1], models[3], [17, 18, 19],
                                       5)


def test_engine_needs_a_card_unless_told_otherwise(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(models[1], models[3])


LAUNCH_ARGV = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
               "3", "--max-new", "4"]


def _launched_tokens(*extra):
    reqs, _, _ = t_launch.serve(t_launch.parse_args(LAUNCH_ARGV + list(extra)))
    return [r.tokens for r in reqs]


def test_launcher_serves_on_the_cpu(capsys, tmp_path):
    """The launcher serves its seeded parameters, and with ``--ckpt-dir``
    a checkpoint that ``repro`` wrote (params only, as ``repro``'s
    launcher restores it): token for token ``repro``'s engine on those
    parameters and the launcher's requests."""
    assert t_launch.main(LAUNCH_ARGV) == 0
    assert capsys.readouterr().out.startswith("3 requests, 12 tokens")
    jcfg = j_smoke_config(ARCH)
    jp = japi.init_params(jcfg, jax.random.key(7))
    ckpt = str(tmp_path / "ckpt")
    j_save(ckpt, 5, {"params": jp})
    assert t_launch.main(LAUNCH_ARGV + ["--ckpt-dir", ckpt]) == 0
    assert capsys.readouterr().out.startswith("3 requests, 12 tokens")
    je = JEngine(jcfg, jp, slots=4, max_len=256)
    rng = np.random.default_rng(1)
    jr = [je.submit(JRequest(rng.integers(16, jcfg.vocab_size, 16).tolist(),
                             max_new_tokens=4, stop_at_eos=False))
          for _ in range(3)]
    je.run()
    got = _launched_tokens("--ckpt-dir", ckpt)
    assert got == [r.tokens for r in jr]
    assert got != _launched_tokens()


def test_launcher_keeps_seeded_params_without_a_checkpoint(tmp_path):
    """A ``--ckpt-dir`` with no step in it keeps the seeded parameters,
    as in ``repro``."""
    assert _launched_tokens("--ckpt-dir", str(tmp_path)) == \
        _launched_tokens()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-130m",
                                  "internvl2-2b", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_launcher_takes_every_ported_family(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
            "--max-new", "3"]
    assert t_launch.main(argv) == 0
    assert capsys.readouterr().out.startswith("2 requests, 6 tokens")
