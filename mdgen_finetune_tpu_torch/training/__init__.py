"""Training runtime."""
from .trainer import Optimizer, TrainState, Trainer, make_optimizer, read_checkpoint

__all__ = ["Optimizer", "TrainState", "Trainer", "make_optimizer", "read_checkpoint"]
