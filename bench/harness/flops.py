"""Operations and bytes the benchmark's work needs, counted from the
configuration file's sizes and the shapes of the work, the same whatever
computes it.  A product of an (m, k) by a (k, n) operand is 2mkn
operations; training is three times the forward (the backward takes two
products a forward one).  The input embedding is a lookup and counts
nothing; a mixture counts the experts a token uses (``k`` of them) and
its router.

The operation peak each configuration is held to is in its file
(``compute.peak_flops_per_s``); the HBM rate here.  Both are NVIDIA's
data sheet for one H100 SXM, dense, at the 700 W limit.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_HBM_BYTES_S = 3.35e12


def _dims(cf: Dict):
    d, h = int(cf["hidden_size"]), int(cf["num_attention_heads"])
    kv = int(cf["num_key_value_heads"])
    hd = int(cf.get("head_dim") or d // h)
    return d, h, kv, hd


def layer_matmul_params(cf: Dict) -> int:
    """Weights of one layer that a token multiplies (the active ones)."""
    d, h, kv, hd = _dims(cf)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    ff = int(cf["intermediate_size"])
    if int(cf.get("num_experts", 0)):
        e, k = int(cf["num_experts"]), int(cf["num_experts_per_tok"])
        return attn + k * 3 * d * ff + d * e
    return attn + 3 * d * ff


def head_params(cf: Dict) -> int:
    return int(cf["vocab_size"]) * int(cf["hidden_size"])


def attention_pair_flops(cf: Dict) -> int:
    """Forward operations of one (query, key) pair over all layers:
    q.k and p.v, 2 each, every head."""
    _, h, _, hd = _dims(cf)
    return 4 * h * hd * int(cf["num_hidden_layers"])


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def train_step_flops(cf: Dict, tokens: int,
                     segment_lengths: Iterable[int]) -> float:
    """Model operations of one training step over ``tokens`` real tokens
    packed as ``segment_lengths`` documents (each attends to itself)."""
    per_token = (int(cf["num_hidden_layers"]) * layer_matmul_params(cf)
                 + head_params(cf))
    pairs = sum(causal_pairs(int(n)) for n in segment_lengths)
    return 3.0 * (2.0 * per_token * tokens
                  + attention_pair_flops(cf) * pairs)


def enrich_doc_flops(cf: Dict, prompt: int, new: int) -> float:
    """Forward operations one document needs: the prompt once, logits at
    its last position, then ``new - 1`` decoded tokens, each attending
    over the cache before it."""
    layers = int(cf["num_hidden_layers"]) * layer_matmul_params(cf)
    fl = 2.0 * layers * prompt + 2.0 * head_params(cf)
    fl += attention_pair_flops(cf) * causal_pairs(prompt)
    for i in range(1, new):
        ctx = prompt + i
        fl += 2.0 * (layers + head_params(cf))
        fl += attention_pair_flops(cf) * ctx
    return fl


def prompt_attention_bound_s(cf: Dict, prompt: int, peak: float,
                             itemsize: int = 2) -> Tuple[float, str]:
    """Least seconds of one prompt's causal attention over all layers:
    each layer's operations at ``peak`` or its bytes (q, k, v read once,
    the output written once) at the HBM rate, whichever is longer."""
    _, h, kv, hd = _dims(cf)
    layers = int(cf["num_hidden_layers"])
    ops = attention_pair_flops(cf) / layers * causal_pairs(prompt)
    nbytes = (2 * h + 2 * kv) * hd * prompt * itemsize
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES_S
    if t_ops >= t_bytes:
        return layers * t_ops, "operations"
    return layers * t_bytes, "bytes"
