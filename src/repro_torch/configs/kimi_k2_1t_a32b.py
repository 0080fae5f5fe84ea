"""kimi-k2-1t-a32b — Kimi K2, trillion-param MoE (paper-table config).
[arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("kimi-k2-1t-a32b")
def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,           # GQA kv=8
        d_ff=2048,                # per-expert FFN width
        vocab_size=163_840,
        head_dim=112,             # 7168 / 64
        num_experts=384,
        experts_per_token=8,
        moe_period=1,
        param_dtype="bfloat16",   # 1T params: bf16 master + sharded opt state
        remat="full",
        source="arXiv:2501.kimi2; unverified",
    )
