"""Optimizers, schedules and gradient utilities over parameter trees."""
from .grad_utils import (
    GradAccumulator,
    clip_by_global_norm,
    error_feedback_compress,
    global_norm,
    init_residual,
    value_and_grad,
)
from .optimizers import OptState, adamw, sgd_momentum
from .schedules import constant, cosine_with_warmup, linear_warmup

__all__ = [
    "adamw", "sgd_momentum", "OptState", "constant", "cosine_with_warmup",
    "linear_warmup", "clip_by_global_norm", "global_norm",
    "GradAccumulator", "error_feedback_compress", "init_residual",
    "value_and_grad",
]
