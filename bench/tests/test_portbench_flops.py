"""The model operation counts the mfu and roofline metrics divide by,
against hand counts."""

import math

from bench.harness import flops
from bench.harness.cell import load_cell
from bench.tests import tiny


def test_tiny_moe_counts_the_experts_a_token_uses():
    cf = tiny.MOE                        # d 64, 4 heads of 16, 8 experts
    attn = 4 * 64 * 64                   # q, k, v, o
    experts = 2 * 3 * 64 * 32            # top-2 of 8, SwiGLU
    router = 64 * 8
    assert flops.layer_matmul_params(cf) == attn + experts + router
    per_token = 2 * (attn + experts + router) + 512 * 64   # + the head
    pairs = 10 * 11 // 2 + 3 * 4 // 2
    want = 3 * (2 * per_token * 13 + 4 * 4 * 16 * 2 * pairs)
    assert flops.train_step_flops(cf, 13, [10, 3]) == want


def test_dense_counts_no_embedding_lookup():
    cf = tiny.DENSE                      # 4 query heads, 2 kv heads
    attn = 64 * 64 + 2 * 64 * 32 + 64 * 64
    assert flops.layer_matmul_params(cf) == attn + 3 * 64 * 128
    doc = flops.enrich_doc_flops(cf, 5, 3)
    layers = 2 * flops.layer_matmul_params(cf)
    want = (2 * layers * 5 + 2 * 512 * 64 + 4 * 4 * 16 * 2 * 15
            + sum(2 * (layers + 512 * 64) + 4 * 4 * 16 * 2 * (5 + i)
                  for i in (1, 2)))
    assert doc == want


def test_olmoe_active_share():
    """8 of 64 experts, no input embedding: about 372 M matmul weights a
    token, where every expert and the embedding (the count of 6 x every
    parameter) make about 1.88 G, five times as many."""
    cf = load_cell("train.olmoe-1b-7b.feed").config
    active = 4 * flops.layer_matmul_params(cf) + flops.head_params(cf)
    assert math.isclose(active, 371.9e6, rel_tol=1e-3)
    every = active + 4 * 56 * 3 * 2048 * 1024 + flops.head_params(cf)
    assert 5 < every / active < 5.1


def test_prompt_attention_bound():
    cf = load_cell("enrich.deepseek-coder-33b.longdoc").config
    s, kind = flops.prompt_attention_bound_s(cf, 4096, 989e12)
    assert kind == "operations"
    assert math.isclose(s, 4 * 4 * 56 * 128 * 4096 * 4097 / 2 / 989e12)
    s, kind = flops.prompt_attention_bound_s(cf, 64, 989e12)
    assert kind == "bytes"
    assert math.isclose(s, 4 * (2 * 56 + 2 * 8) * 128 * 64 * 2 / 3.35e12)
