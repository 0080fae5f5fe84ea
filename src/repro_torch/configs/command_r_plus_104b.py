"""command-r-plus-104b — Cohere Command R+ class dense LM (GQA, no-bias).
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("command-r-plus-104b")
def command_r_plus_104b() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12_288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=33_792,
        vocab_size=256_000,
        head_dim=128,
        qkv_bias=False,
        tie_embeddings=True,      # command-r ties input/output embeddings
        param_dtype="bfloat16",
        remat="full",
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )
