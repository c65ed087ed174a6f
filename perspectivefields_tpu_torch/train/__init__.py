"""Training: the loss functions, AdamW wiring and the train step.

Port of perspectivefields_tpu/train: the reference's objectives as tensor
functions, and a PyTorch training loop on one device.
"""

from .losses import (
    cross_entropy_loss,
    gravity_regression_loss,
    latitude_regression_loss,
    meanstd_tanh_norm_loss,
    msgil_norm_loss,
    param_loss,
    total_loss,
)
from .train_step import (
    TrainState,
    clip_by_global_norm_,
    create_train_state,
    make_train_loop,
    make_train_step,
)

__all__ = [
    "msgil_norm_loss",
    "meanstd_tanh_norm_loss",
    "gravity_regression_loss",
    "latitude_regression_loss",
    "cross_entropy_loss",
    "param_loss",
    "total_loss",
    "TrainState",
    "clip_by_global_norm_",
    "create_train_state",
    "make_train_step",
    "make_train_loop",
]
