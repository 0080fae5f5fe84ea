"""qwen1.5-32b — Qwen 1.5 32B dense LM (QKV bias). [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-32b")
def qwen1_5_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,          # MHA (GQA kv=40)
        d_ff=27_392,
        vocab_size=152_064,
        head_dim=128,
        qkv_bias=True,            # Qwen-style attention bias
        param_dtype="bfloat16",
        remat="full",
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
