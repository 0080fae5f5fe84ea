"""deepseek-coder-33b — llama-architecture dense code LM. [arXiv:2401.14196; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-coder-33b")
def deepseek_coder_33b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        num_layers=62,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=19_200,
        vocab_size=32_256,
        head_dim=128,
        param_dtype="bfloat16",
        remat="full",
        source="arXiv:2401.14196; hf",
    )
