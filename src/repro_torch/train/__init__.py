from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    lr_at,
)
from repro_torch.train.step import (
    TrainConfig,
    init_train_state,
    init_train_state_shapes,
    make_eval_step,
    make_train_step,
    train_state_to_device,
)

__all__ = [
    "OptimizerConfig", "TrainConfig", "adamw_update", "init_opt_state",
    "init_train_state", "init_train_state_shapes", "lr_at", "make_eval_step", "make_train_step",
    "train_state_to_device",
]
