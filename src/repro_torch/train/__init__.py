"""Training of the port: AdamW, the train step, K-safe checkpoints and the
fault-tolerance helpers.  Mirrors ``src/repro/train/``; the dry-run's
``abstract_train_state`` and ``train_state_axes`` wait for its slice."""
from .optim import OptState, adamw_update, init_opt_state, lr_schedule
from .train_step import init_train_state, make_train_step

__all__ = ["OptState", "adamw_update", "init_opt_state", "lr_schedule",
           "init_train_state", "make_train_step"]
