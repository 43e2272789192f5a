"""Training: optimizers and schedules, checkpoints, metrics, the flow,
VQ-VAE, residual and two-level trainers."""

from . import optim  # registers optimizers/schedulers
from .checkpoint import load_checkpoint, load_params, save_checkpoint
from .metrics import MetricsWriter
from .optim import Optimizer, build_optimizer, warmup_exp_schedule
from .residual_trainer import ResidualTrainer
from .trainer import Trainer
from .twolevel_trainer import TwoLevelTrainer
from .vqvae_trainer import VQVAETrainer

__all__ = [
    "optim",
    "load_checkpoint",
    "load_params",
    "save_checkpoint",
    "MetricsWriter",
    "Optimizer",
    "build_optimizer",
    "warmup_exp_schedule",
    "Trainer",
    "VQVAETrainer",
    "ResidualTrainer",
    "TwoLevelTrainer",
]
