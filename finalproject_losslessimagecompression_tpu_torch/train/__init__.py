"""Training: optimizers and schedules, checkpoints (either package's),
metrics, the flow trainer's step makers (captured as CUDA graphs on the
card), the flow, VQ-VAE, residual and two-level trainers and the
fine-tuner."""

from . import optim  # registers optimizers/schedulers
from .checkpoint import load_checkpoint, load_params, save_checkpoint
from .finetuner import Finetuner
from .metrics import MetricsWriter
from .msgpack import load_raw, msgpack_restore
from .optim import Optimizer, build_optimizer, warmup_exp_schedule
from .residual_trainer import ResidualTrainer
from .trainer import (
    Trainer,
    make_forward,
    make_multi_train_step,
    make_train_step,
)
from .twolevel_trainer import TwoLevelTrainer
from .vqvae_trainer import VQVAETrainer

__all__ = [
    "optim",
    "load_checkpoint",
    "load_params",
    "load_raw",
    "msgpack_restore",
    "save_checkpoint",
    "MetricsWriter",
    "Optimizer",
    "build_optimizer",
    "warmup_exp_schedule",
    "Trainer",
    "make_forward",
    "make_multi_train_step",
    "make_train_step",
    "VQVAETrainer",
    "ResidualTrainer",
    "TwoLevelTrainer",
    "Finetuner",
]
