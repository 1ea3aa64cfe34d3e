"""Training: per-stage losses and masks, the optimizer, the trainer, and the
face nets' training and weight files."""

from emox_torch.train.face_nets import load_face_nets, load_face_nets_into, save_face_nets, train_face_nets
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
    "load_face_nets",
    "load_face_nets_into",
    "make_optimizer",
    "sample_draws",
    "save_face_nets",
    "stage_loss_fn",
    "train_face_nets",
    "trainable_mask",
]
