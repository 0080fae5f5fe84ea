"""Model / shape configuration for the repro framework.

Every assigned architecture is a ``ModelConfig`` registered under its public id
(``--arch <id>``).  Configs are frozen dataclasses so they can be hashed into
the predeploy (AOT compile) cache key — the same mechanism the paper uses for
parameterized predeployed jobs, where the *query* is compiled once and invoked
per batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``family`` selects the forward implementation:
      dense   — decoder-only transformer (GQA + SwiGLU)
      moe     — decoder-only transformer with MoE FFN every ``moe_period`` layers
      ssm     — Mamba2 (SSD) stack, attention-free
      hybrid  — Jamba-style 1:``attn_period`` attention:mamba interleave (+MoE)
      encdec  — Whisper-style encoder/decoder (stubbed conv frontend)
      vlm     — decoder-only LM with prepended patch-embedding stub
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1          # MoE FFN on layers where (i % moe_period)==moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_ep: bool = False          # explicit shard_map expert parallelism
                                  # (all_to_all dispatch) instead of GSPMD

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (Jamba) ---
    attn_period: int = 0          # one attention layer per ``attn_period`` layers
    attn_offset: int = 4          # its index within the period

    # --- encdec (Whisper) ---
    encoder_layers: int = 0

    # --- modality frontend stubs (audio frames / vision patches) ---
    num_frontend_tokens: int = 0

    # --- misc ---
    qkv_bias: bool = False
    mlp_variant: str = "swiglu"   # "swiglu" | "gelu"
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"       # activation dtype
    param_dtype: str = "float32"  # parameter dtype (bf16 for the huge archs)
    remat: str = "full"           # "none" | "dots" | "full"
    logits_softcap: float = 0.0
    source: str = ""              # provenance tag from the assignment table

    # ---------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return (i % self.moe_period) == self.moe_offset

    def attn_layer(self, i: int) -> bool:
        """hybrid family: which layers are attention (vs mamba)."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return (i % self.attn_period) == self.attn_offset

    @property
    def is_subquadratic(self) -> bool:
        """True when the arch can serve ``long_500k`` (attention-free or
        hybrid with O(S) memory growth only on a small fraction of layers)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter-count estimate (used for roofline MODEL_FLOPS = 6·N·D).
    def param_count(self, active_only: bool = False) -> int:
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d

        def attn_params() -> int:
            p = d * self.num_heads * hd           # q
            p += 2 * d * self.num_kv_heads * hd   # k, v
            p += self.num_heads * hd * d          # o
            if self.qkv_bias:
                p += (self.num_heads + 2 * self.num_kv_heads) * hd
            return p

        def dense_ffn() -> int:
            if self.mlp_variant == "swiglu":
                return 3 * d * self.d_ff
            return 2 * d * self.d_ff

        def moe_ffn() -> int:
            per_expert = 3 * d * self.d_ff
            e = self.experts_per_token if active_only else self.num_experts
            return e * per_expert + d * self.num_experts  # + router

        def mamba_params() -> int:
            di = self.d_inner
            n_ = d * (2 * di + 2 * self.ssm_state + self.ssm_heads)  # in_proj
            n_ += self.ssm_conv * (di + 2 * self.ssm_state)          # conv
            n_ += self.ssm_heads * 2                                  # A, D
            n_ += di * d                                              # out_proj
            return n_

        for i in range(self.num_layers):
            if self.family == "ssm":
                n += mamba_params()
                continue
            if self.family == "hybrid" and not self.attn_layer(i):
                n += mamba_params()
            else:
                n += attn_params()
            if self.family != "ssm":
                n += moe_ffn() if self.moe_layer(i) else dense_ffn()
        if self.family == "encdec":
            for _ in range(self.encoder_layers):
                n += attn_params() + dense_ffn()   # encoder self-attn + mlp
            n += self.num_layers * attn_params()   # decoder cross-attn
        n += 2 * d * max(self.num_layers, 1)       # norms (approx)
        return n


# ---------------------------------------------------------------------------
# Input-shape specifications (assigned per-arch shape set)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Returns (applicable, reason-if-not). long_500k needs sub-quadratic
    attention; pure full-attention archs skip it."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "skipped (full-attention arch; long_500k needs sub-quadratic)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs as _c  # noqa: F401
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    cfg = get_config(arch_id)
    kw = dict(
        num_layers=2 if cfg.family != "hybrid" else cfg.attn_period,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2)
    if cfg.num_frontend_tokens:
        kw.update(num_frontend_tokens=8)
    return cfg.replace(**kw)
