from repro_torch.ckpt.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    all_steps,
    latest_step,
    restore,
    save,
)
