"""Training: the microbatched train step, the fault-tolerant loop, atomic
checkpoints and fault handling."""
from . import checkpoint, fault, loop, step
from .step import TrainState, init_state, loss_fn, train_step

__all__ = ["checkpoint", "fault", "loop", "step",
           "TrainState", "init_state", "loss_fn", "train_step"]
