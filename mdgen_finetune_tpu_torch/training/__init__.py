"""Training runtime."""
from .trainer import Optimizer, TrainState, Trainer, make_optimizer

__all__ = ["Optimizer", "TrainState", "Trainer", "make_optimizer"]
