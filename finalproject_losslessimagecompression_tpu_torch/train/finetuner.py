"""Per-image fine-tuning and bpd measurement: the JAX package's `Finetuner`
on PyTorch.

Loads a trained flow (`model.load_path`: a checkpoint of this package or a
JAX msgpack one) and freezes it, then measures bpd over the train stream.
With `fine_tune` on, a zero-initialised "tuner" of the image's shape
(H, W, C), added to every NHWC batch, is optimized on the mean negative
log-likelihood to adapt the frozen model to the stream: by Adam at
`fine_tune_lr` (constant, optax.adam's algebra) when that is given, else by
the config's optimizer and schedule.  The tuner is the run's artifact: it
and its optimizer state are saved every `save_interval` steps and at the
end, and `resume` restores them.

Each step logs its bpd (one host sync per step, as in JAX); every
`evaluate_interval` steps the mean since the last one is logged as
`bpd mean`.  A tuning step is one `utils.graphs.GraphedStep`: on the card
it is captured as a CUDA graph at its second call and replayed after.
The fine-tuner runs on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..codec.interleaved import to_device
from ..convert import params_from_flax
from ..data import loader as _loader  # noqa: F401  (registers loaders)
from ..models.config import FlowCfg
from ..models.idflow import IDFlow, log_likelihood, resolve_device
from ..registry import DATALOADERS, TRAINERS, build
from ..utils.graphs import optimizer_step
from .checkpoint import load_checkpoint, load_params, save_checkpoint
from .metrics import MetricsWriter
from .optim import build_optimizer

LN2 = math.log(2.0)


@TRAINERS.register(name="Finetuner")
class Finetuner:
    """Config shape: the `train` subtree of configs/config-trans-test.yaml."""

    def __init__(
        self,
        model: dict,
        train_dataloader: dict,
        test_dataloader: dict,
        optimizer: dict,
        scheduler: dict,
        max_step: int,
        step_per_epoch: int,
        evaluate_interval: int,
        save_interval: int,
        save_path: str,
        writer_path: str,
        fine_tune: bool = False,
        fine_tune_lr: Optional[float] = None,
        seed: int = 0,
        resume: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        model = dict(model)
        load_path = model.pop("load_path", None)
        self.cfg = FlowCfg.from_ref(model)
        self.model = IDFlow(self.cfg, device=self.device, seed=seed)
        if load_path:
            self.model.load_state_dict(
                load_params(load_path, self.device, params_from_flax))
        self.model.eval().requires_grad_(False)
        self.trainloader = build(DATALOADERS, train_dataloader)
        self.testloader = build(DATALOADERS, test_dataloader)
        self.max_step = max_step
        self.evaluate_interval = evaluate_interval
        self.save_interval = save_interval
        self.save_path = save_path
        self.writer = MetricsWriter(writer_path)
        self.step = 0
        self.fine_tune = fine_tune

        cfg = self.cfg
        self.tuner = torch.zeros((cfg.H, cfg.W, cfg.C), device=self.device,
                                 requires_grad=True)
        if fine_tune_lr is not None:
            optimizer, scheduler = {"name": "Adam", "lr": fine_tune_lr}, None
        self.tuner_opt = build_optimizer([self.tuner], optimizer, scheduler,
                                         step_per_epoch)
        if resume:
            self.restore(self.save_path)
        self.tune_step = optimizer_step(self._tune_body, self.tuner_opt,
                                        self.device)
        self.graphs = self.tune_step.graphs

    # -- checkpointing: the tuner and its optimizer state ------------------

    def _state(self):
        return {"tuner": self.tuner.detach(),
                "tuner_state": self.tuner_opt.state_dict(),
                "step": self.step}

    def save(self, path: Optional[str] = None):
        save_checkpoint(path or self.save_path, self._state())

    def restore(self, path: str):
        st = load_checkpoint(path, self.device)
        with torch.no_grad():
            self.tuner.copy_(st["tuner"])
        self.tuner_opt.load_state_dict(st["tuner_state"])
        self.step = int(st["step"])

    # -- steps ------------------------------------------------------------

    def loss_fn(self, batch: torch.Tensor) -> torch.Tensor:
        """Mean NLL (nats/dim) of an NHWC batch with the tuner added."""
        latents, means, logscales = self.model(batch + self.tuner[None])
        lp, _ = log_likelihood(self.cfg, latents, means, logscales)
        return -lp.mean()

    def _tune_body(self, batch: torch.Tensor) -> torch.Tensor:
        """The body of `tune_step(batch)`: one update of the tuner; returns
        the loss on the device."""
        loss = self.loss_fn(batch)
        self.tuner_opt.zero_grad()
        loss.backward()
        self.tuner_opt.update(self.tuner_opt.lrs(1)[0])
        return loss.detach()

    def train(self):
        bpds = []
        while self.step < self.max_step:
            self.step += 1
            batch = to_device(torch.from_numpy(np.asarray(
                next(self.trainloader))), self.device)
            if self.fine_tune:
                loss = self.tune_step(batch)
            else:
                with torch.no_grad():
                    loss = self.loss_fn(batch)
            bpd = float(loss) / LN2
            bpds.append(bpd)
            self.writer.add_scalar("bpd", bpd, self.step)
            if self.step % self.evaluate_interval == 0:
                self.writer.add_scalar("bpd mean", float(np.mean(bpds)),
                                       self.step)
                bpds = []
            if self.fine_tune and self.step % self.save_interval == 0:
                self.save()
        if self.fine_tune:
            self.save()
