"""Training steps and the train checkpoint (twin of the JAX package's
``training``)."""

from repro_torch.training.trainer import (
    TrainState,
    make_ensemble_train_step,
    make_train_step,
    train_state_shapes,
)

__all__ = ["TrainState", "make_train_step", "make_ensemble_train_step",
           "train_state_shapes"]
