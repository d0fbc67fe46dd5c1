"""Training substrate: optimizer, train step, loop, grad compression."""
from . import optimizer
from .loop import LoopConfig, LoopState, run_training
from .train_step import jit_train_step, make_train_step

__all__ = ["optimizer", "LoopConfig", "LoopState", "run_training",
           "jit_train_step", "make_train_step"]
