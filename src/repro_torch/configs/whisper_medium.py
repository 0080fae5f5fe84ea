"""whisper-medium — encoder/decoder speech model; conv frontend STUBBED
(``input_specs()`` supplies precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-medium")
def whisper_medium() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        num_layers=24,            # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51_865,
        head_dim=64,
        mlp_variant="gelu",
        qkv_bias=True,            # whisper uses biased projections
        tie_embeddings=True,
        num_frontend_tokens=1536, # ~30 s of audio after the (stubbed) conv
                                  # stack; 1500 padded to 1536 for TPU-aligned
                                  # attention blocks (see DESIGN.md §2)
        param_dtype="float32",
        remat="dots",
        source="arXiv:2212.04356; unverified",
    )
