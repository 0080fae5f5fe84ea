"""Config registry — importing this package registers all assigned archs."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    register,
    shape_applicable,
    smoke_config,
)

# Registration side effects (one module per assigned architecture).
from repro_torch.configs import olmoe_1b_7b  # noqa: F401
from repro_torch.configs import kimi_k2_1t_a32b  # noqa: F401
from repro_torch.configs import command_r_plus_104b  # noqa: F401
from repro_torch.configs import qwen1_5_32b  # noqa: F401
from repro_torch.configs import deepseek_coder_33b  # noqa: F401
from repro_torch.configs import command_r_35b  # noqa: F401
from repro_torch.configs import mamba2_130m  # noqa: F401
from repro_torch.configs import whisper_medium  # noqa: F401
from repro_torch.configs import internvl2_2b  # noqa: F401
from repro_torch.configs import jamba_1_5_large_398b  # noqa: F401

ALL_ARCHS = (
    "olmoe-1b-7b",
    "kimi-k2-1t-a32b",
    "command-r-plus-104b",
    "qwen1.5-32b",
    "deepseek-coder-33b",
    "command-r-35b",
    "mamba2-130m",
    "whisper-medium",
    "internvl2-2b",
    "jamba-1.5-large-398b",
)
