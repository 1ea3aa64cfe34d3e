"""Training: per-stage losses and masks, the optimizer, the trainer."""

from emox_torch.train.stages import (
    STAGE_DESCRIPTIONS,
    downsample_mask,
    sample_draws,
    stage_loss_fn,
    trainable_mask,
)
from emox_torch.train.trainer import (
    Checkpointer,
    MetricsLogger,
    Optimizer,
    Trainer,
    TrainState,
    make_optimizer,
)

__all__ = [
    "STAGE_DESCRIPTIONS",
    "Checkpointer",
    "MetricsLogger",
    "Optimizer",
    "TrainState",
    "Trainer",
    "downsample_mask",
    "make_optimizer",
    "sample_draws",
    "stage_loss_fn",
    "trainable_mask",
]
