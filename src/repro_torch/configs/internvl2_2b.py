"""internvl2-2b — InternViT + InternLM2 VLM; ViT frontend STUBBED
(``input_specs()`` supplies precomputed patch embeddings). [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("internvl2-2b")
def internvl2_2b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92_553,
        head_dim=128,
        tie_embeddings=True,
        num_frontend_tokens=256,  # one image tile worth of patch embeddings
        param_dtype="float32",
        remat="dots",
        source="arXiv:2404.16821; hf",
    )
