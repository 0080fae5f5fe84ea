"""mamba2-130m — Mamba-2 SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-130m")
def mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=0,              # attention-free
        num_kv_heads=0,
        d_ff=0,                   # no MLP; mixer is the SSD block
        vocab_size=50_280,
        ssm_state=128,
        ssm_expand=2,             # d_inner = 1536
        ssm_headdim=64,           # 24 SSD heads
        ssm_conv=4,
        ssm_chunk=256,
        tie_embeddings=True,
        param_dtype="float32",
        remat="full",   # chunked-SSD intra-chunk tensors are O(S*Q*H):
                        # without remat the 24-layer backward residuals
                        # exceed HBM at train_4k (see EXPERIMENTS.md)
        source="arXiv:2405.21060; unverified",
    )
