"""Training of the port: AdamW, the train step (and the dry-run's
abstract train state and its axes), K-safe checkpoints and the
fault-tolerance helpers.  Mirrors ``src/repro/train/``."""
from .optim import OptState, adamw_update, init_opt_state, lr_schedule
from .train_step import (abstract_train_state, init_train_state,
                         make_train_step, train_state_axes)

__all__ = ["OptState", "adamw_update", "init_opt_state", "lr_schedule",
           "abstract_train_state", "init_train_state", "make_train_step",
           "train_state_axes"]
