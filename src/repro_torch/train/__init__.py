"""Training: the train step and the single-device pattern-bucketed trainer."""
from .loop import StragglerWatchdog, Trainer, TrainerConfig, TrainState
from .train_step import make_train_step

__all__ = ["StragglerWatchdog", "Trainer", "TrainerConfig", "TrainState",
           "make_train_step"]
