"""A configuration file as the port's ``ModelConfig``.

The file keeps the published ``config.json`` keys at its top level, with
the values as run; ``compute`` gives the dtypes and the peak.  The port's
registered configuration ``port_arch`` supplies what the file does not
set (family, remat policy, MoE period); every key the file does set must
reach the port unchanged, which ``model_config`` checks.
"""

from __future__ import annotations

from typing import Dict

# published key -> ModelConfig field
FIELDS = {
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "num_hidden_layers": "num_layers",
    "head_dim": "head_dim",
    "rms_norm_eps": "norm_eps",
    "rope_theta": "rope_theta",
    "num_experts": "num_experts",
    "num_experts_per_tok": "experts_per_token",
    "tie_word_embeddings": "tie_embeddings",
    "capacity_factor": "capacity_factor",
}


def head_dim(cf: Dict) -> int:
    return int(cf.get("head_dim")
               or cf["hidden_size"] // cf["num_attention_heads"])


def model_config(cf: Dict):
    """The port's ModelConfig for configuration file ``cf``."""
    from repro_torch.configs import get_config
    base = get_config(cf["port_arch"])
    kw = {f: cf[k] for k, f in FIELDS.items() if k in cf}
    kw["head_dim"] = head_dim(cf)
    kw["param_dtype"] = cf["compute"]["param_dtype"]
    kw["dtype"] = cf["compute"]["activation_dtype"]
    cfg = base.replace(**kw)
    for field, value in kw.items():
        if getattr(cfg, field) != value:
            raise ValueError(f"{cf['name']}: {field} is {getattr(cfg, field)}"
                             f" in the port, {value} in the file")
    if cf.get("norm_topk_prob") is False or cf.get("rope_scaling"):
        raise ValueError(f"{cf['name']}: the port renormalises the top-k "
                         "weights and has no RoPE scaling")
    return cfg
