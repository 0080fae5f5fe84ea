"""jamba-1.5-large-398b — Jamba hybrid: Mamba + attention 7:1 interleave,
MoE 16e top-2 on alternating layers. [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("jamba-1.5-large-398b")
def jamba_1_5_large_398b() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,            # 9 periods of 8 (7 mamba + 1 attention)
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24_576,              # per-expert / dense FFN width
        vocab_size=65_536,
        head_dim=128,
        num_experts=16,
        experts_per_token=2,
        moe_period=2,             # MoE FFN every other layer
        moe_offset=1,
        attn_period=8,            # attention layer once per 8
        attn_offset=4,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_conv=4,
        ssm_chunk=256,
        param_dtype="bfloat16",
        remat="full",
        source="arXiv:2403.19887; hf",
    )
