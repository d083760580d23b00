from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state, lr_at
from repro_torch.train.train_step import (
    TrainConfig,
    batch_spec_tree,
    build_train_step,
    init_train_state,
    make_train_step,
    train_state_specs,
)

__all__ = [
    "OptConfig",
    "adamw_update",
    "init_opt_state",
    "lr_at",
    "TrainConfig",
    "batch_spec_tree",
    "build_train_step",
    "init_train_state",
    "make_train_step",
    "train_state_specs",
]
