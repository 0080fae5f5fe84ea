"""olmoe-1b-7b — OLMoE: 7B total / 1B active MoE LM. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("olmoe-1b-7b")
def olmoe_1b_7b() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,          # GQA kv=16 (MHA-equivalent)
        d_ff=1024,                # per-expert FFN width
        vocab_size=50_304,
        head_dim=128,
        num_experts=64,
        experts_per_token=8,
        moe_period=1,             # every layer is MoE
        param_dtype="float32",
        remat="dots",
        source="arXiv:2409.02060; hf",
    )
