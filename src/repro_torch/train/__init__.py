"""The LM train step (port of ``repro.train``)."""

from .step import TrainHParams, TrainState, init_train_state, make_train_step

__all__ = ["TrainState", "TrainHParams", "init_train_state",
           "make_train_step"]
