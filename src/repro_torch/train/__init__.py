from repro_torch.train.optimizer import (  # noqa: F401
    OptConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.train.steps import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
    state_from_numpy,
    state_to_numpy,
    train_state_axes,
    train_state_shapes,
)
