"""The plain reference agrees with the port's plain (CPU) path at a tiny
size, in float32: the model's loss, gradients and logits, and the data
plane's flags and tokens."""

import numpy as np
import pytest
import torch

from bench.data import tweets
from bench.harness import env, portcfg, weights
from bench.reference import data_plane, model
from bench.tests import tiny

env.prepare()


def _packed(seed, seq=64, rows=2, vocab=512):
    rng = np.random.default_rng(seed)
    packer = data_plane.Packer(seq, rows)
    while True:
        out = packer.add(rng.integers(16, vocab, rng.integers(3, 12)))
        if out is not None:
            return out


@pytest.mark.parametrize("cf", [tiny.DENSE, tiny.MOE],
                         ids=["dense", "moe"])
def test_loss_and_gradients_match_the_port(cf):
    from repro_torch.models import api
    from repro_torch.models.params import tree_flatten
    cfg = portcfg.model_config(cf)
    w = weights.draw(cfg, 3, torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in _packed(1).items()}
    leaves, struct = tree_flatten(w)
    mine = [p.detach().clone().requires_grad_() for p in leaves]
    from repro_torch.models.params import tree_unflatten
    total, _ = api.loss(cfg, tree_unflatten(struct, mine), batch)
    g_port = torch.autograd.grad(total, mine)
    ref_leaves = [p.detach().clone().requires_grad_() for p in leaves]
    ref_total, _ = model.loss(model.Dims(cf), tree_unflatten(struct,
                                                             ref_leaves),
                              batch, "float32")
    g_ref = torch.autograd.grad(ref_total, ref_leaves)
    assert abs(float(total.detach()) - float(ref_total.detach())) < 1e-5
    for a, b in zip(g_port, g_ref):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-9


def test_sequence_logits_match_the_port():
    from repro_torch.models import api
    cfg = portcfg.model_config(tiny.DENSE)
    w = weights.draw(cfg, 4, torch.device("cpu"))
    toks = list(range(20, 60))
    port, _ = api.apply(cfg, w, {"tokens": torch.tensor([toks])})
    ref = model.sequence_logits(model.Dims(tiny.DENSE), w, toks,
                                [0, 17, 39], "float32", "cpu")
    assert torch.allclose(port[0, [0, 17, 39]], ref, atol=1e-4)


def test_fp8_control_departs():
    cfg = portcfg.model_config(tiny.DENSE)
    w = weights.draw(cfg, 4, torch.device("cpu"))
    toks = list(range(20, 60))
    dm = model.Dims(tiny.DENSE)
    a = model.sequence_logits(dm, w, toks, [39], "float32", "cpu")
    b = model.sequence_logits(dm, w, toks, [39], "fp8", "cpu")
    assert float((a - b).abs().max()) > 1e-3


def test_flags_and_tokens_match_the_port():
    from repro_torch.core import records
    from repro_torch.core.enrich import queries as Q
    lines = next(tweets.TweetStream(5, 2000).frames(2000))
    table = tweets.sensitive_words(6, n=3000)
    batch = {k: torch.from_numpy(v)
             for k, v in records.parse_json_lines(lines).items()}
    refs = {"sensitive_words": {
        "key": torch.from_numpy(table["key"]),
        "country": torch.from_numpy(table["country"]),
        "word": torch.from_numpy(table["word"])}}
    flag = Q.UDF2.apply_fn(batch, None, refs)["safety_check_flag"]
    ids = Q.make_lm_tokenize(512).apply_fn(batch, None, refs)["lm_tokens"]
    index = data_plane.sensitive_index(table)
    import json
    flagged = 0
    for i, raw in enumerate(lines):
        doc = data_plane.enrich(json.loads(raw), index, 512)
        assert (doc is None) == bool(flag[i])
        flagged += doc is None
        if doc is not None:
            assert doc == [int(t) for t in ids[i] if t != 0]
    assert 0 < flagged < len(lines)
