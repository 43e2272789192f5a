"""Training: optimizers and schedules, checkpoints, metrics, the flow
trainer."""

from . import optim  # registers optimizers/schedulers
from .checkpoint import load_checkpoint, save_checkpoint
from .metrics import MetricsWriter
from .optim import Optimizer, build_optimizer, warmup_exp_schedule
from .trainer import Trainer

__all__ = [
    "optim",
    "load_checkpoint",
    "save_checkpoint",
    "MetricsWriter",
    "Optimizer",
    "build_optimizer",
    "warmup_exp_schedule",
    "Trainer",
]
