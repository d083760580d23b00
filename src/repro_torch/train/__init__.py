from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state, lr_at
from repro_torch.train.train_step import TrainConfig, build_train_step, init_train_state

__all__ = [
    "OptConfig",
    "adamw_update",
    "init_opt_state",
    "lr_at",
    "TrainConfig",
    "build_train_step",
    "init_train_state",
]
