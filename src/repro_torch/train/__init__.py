from .step import (grads_and_metrics, init_train_state, train_state_specs,
                   train_step)
from .trainer import Trainer, TrainerConfig, TrainerReport

__all__ = ["grads_and_metrics", "init_train_state", "train_state_specs",
           "train_step", "Trainer", "TrainerConfig", "TrainerReport"]
