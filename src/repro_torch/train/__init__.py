"""Training substrate: optimizer, the M-worker train step, data and
checkpointing.  ``Trainer`` stands for the reference's ``TrainState``,
``init_train_state`` and ``make_train_step``: it owns the state and takes
the steps."""
from .optim import OptimConfig, OptState, apply_updates, init_opt_state, schedule
from .train_step import TrainConfig, Trainer
from .data import DataConfig, Pipeline
from . import checkpoint
