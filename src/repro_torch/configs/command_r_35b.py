"""command-r-35b — Cohere Command R dense LM (GQA, no-bias).
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("command-r-35b")
def command_r_35b() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22_528,
        vocab_size=256_000,
        head_dim=128,
        qkv_bias=False,
        tie_embeddings=True,
        param_dtype="bfloat16",
        remat="full",
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )
