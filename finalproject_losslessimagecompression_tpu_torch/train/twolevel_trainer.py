"""Two-level trainer: the JAX package's `TwoLevelTrainer` on PyTorch.

One step computes the rough and the fine loss together (the fine flow's
activations recomputed in the backward pass, `models/twolevel.py`) and
logs the image bpd and the two levels' (`train bpd`, `train bpd 1`,
`train bpd 2`), fetched only at the `log_every` cadence.  Eval gives the
same three on the test batches and, with `test_coding`, compresses and
decompresses each batch for real through `TwoLevelCodec` at its default
granularity, as the flow trainer's codec does ("fused" on the card: CUDA
graph replays of both sub-flows and their rANS kernels), logging `real
bpd` and `coding errors`; then samples at four temperatures.
Checkpoints hold {params, opt_state, step}.

With `use_mesh: true` over several ranks (see train/trainer.py for the
batch and checkpoint conventions) each step is data-parallel and eval
coding goes through `ShardedTwoLevelCodec` when the eval batch divides
over the ranks.

A training step is one `utils.graphs.GraphedStep`: on the card it is
captured as a CUDA graph at its second call (the fine flow's
recomputation included) and replayed after; over a gloo mesh it runs
eagerly (`parallel.sharding.graphs_allowed`).

The trainer runs on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..codec.interleaved import to_device
from ..convert import twolevel_params_from_flax
from ..data import loader as _loader  # noqa: F401  (registers loaders)
from ..models.config import latent_shapes
from ..models.idflow import log_likelihood, resolve_device
from ..models.twolevel import TwoLevelCfg, TwoLevelFlow, twolevel_bpd
from ..models.twolevel_codec import TwoLevelCodec
from ..ops.dlogistic import dlogistic_sample
from ..parallel.full_codecs import ShardedTwoLevelCodec
from ..parallel.sharding import (
    eval_batch,
    global_mean,
    graphs_allowed,
    is_lead,
    local_batch,
    replicate,
    sharded_update,
    trainer_mesh,
)
from ..registry import DATALOADERS, TRAINERS, build
from ..utils.graphs import optimizer_step
from ..utils.profiling import StepClock
from .checkpoint import restore_train_state, save_checkpoint
from .optim import build_optimizer
from .trainer import at_interval, eager_rule, rank0_writer

LN2 = math.log(2.0)


@TRAINERS.register(name="TwoLevelTrainer")
class TwoLevelTrainer:
    """Config shape: the `train` subtree of configs/config_twolevel.yaml."""

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
        seed: int = 0,
        max_eval_batches: int = 0,
        test_coding: bool = False,
        num_streams: int = 4096,
        use_mesh: bool = False,
        log_every: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.mesh = trainer_mesh(use_mesh, self.device)
        model = dict(model)
        self.load_path = model.pop("load_path", None)
        self.cfg = TwoLevelCfg.from_ref(model)
        self.model = TwoLevelFlow(self.cfg, device=self.device, seed=seed)
        self.trainloader = build(DATALOADERS, train_dataloader)
        self.testloader = build(DATALOADERS, test_dataloader)
        self.optimizer = build_optimizer(self.model.parameters(), optimizer,
                                         scheduler, step_per_epoch)
        self.max_step = max_step
        self.step_per_epoch = step_per_epoch
        self.evaluate_interval = evaluate_interval
        self.save_interval = save_interval
        self.save_path = save_path
        self.writer = rank0_writer(writer_path, self.mesh)
        self.max_eval_batches = max_eval_batches
        self.log_every = max(1, log_every)
        self.step = 0
        if self.load_path:
            self.restore(self.load_path)
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        self.train_step = optimizer_step(self._train_body, self.optimizer,
                                         self.device,
                                         graphs=graphs_allowed(self.mesh))
        self.graphs = self.train_step.graphs
        eager_rule(self, self.mesh)
        self.sample_gen = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.test_coding = test_coding
        self.codec = (TwoLevelCodec(self.model, num_streams=num_streams)
                      if test_coding else None)
        self.sharded_codec = (
            None if self.codec is None or self.mesh is None
            else ShardedTwoLevelCodec(self.codec, self.mesh))

    # -- checkpointing ----------------------------------------------------

    def _state(self):
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(), "step": self.step}

    def save(self, path: Optional[str] = None):
        if is_lead(self.mesh):
            save_checkpoint(path or self.save_path, self._state())

    def restore(self, path: str):
        st = restore_train_state(path, self.model, self.optimizer,
                                 twolevel_params_from_flax)
        self.step = int(st["step"])

    # -- steps ------------------------------------------------------------

    def loss_fn(self, batch: torch.Tensor):
        """(rough + fine mean NLL in nats/dim, [rough, fine] stacked)."""
        cfg = self.cfg
        (rl, rm, rs), (fl, fm, fs) = self.model(batch)
        loss_r = -log_likelihood(cfg.rough, rl, rm, rs)[0].mean()
        loss_f = -log_likelihood(cfg.fine, fl, fm, fs)[0].mean()
        return loss_r + loss_f, torch.stack([loss_r, loss_f])

    def _train_body(self, batch: torch.Tensor):
        """The body of `train_step(batch)`: one update; returns (loss,
        [rough, fine] losses) on the device, no host sync (over a mesh:
        this rank's shard, the global loss and this rank's [rough,
        fine])."""
        loss, aux = self.loss_fn(batch)
        return sharded_update(loss, self.optimizer, self.mesh,
                              self.optimizer.lrs(1)[0]), aux.detach()

    @torch.no_grad()
    def eval_step(self, batch: torch.Tensor):
        return self.loss_fn(batch)

    def _bpds(self, aux: torch.Tensor):
        """(image bpd, rough bpd, fine bpd) of the two levels' losses (over
        a mesh, averaged over the ranks)."""
        aux = global_mean(aux, self.mesh)
        bpd1, bpd2 = (float(v) / LN2 for v in aux.cpu().numpy())
        return twolevel_bpd(self.cfg, bpd1, bpd2), bpd1, bpd2

    # -- eval and sampling ------------------------------------------------

    def evaluate(self):
        """Mean (bpd, bpd 1, bpd 2) over the eval batches; with test_coding
        the real coded bpd and the coding errors are logged."""
        out, real_bpds, errors = [], [], 0
        for n, host in enumerate(iter(self.testloader), 1):
            # over a mesh every rank holds the global batch, evaluates its
            # rows and codes them through the sharded codec
            host, part = eval_batch(host, self.testloader, self.mesh)
            codec = self.codec if part is None else self.sharded_codec
            host = np.ascontiguousarray(host)
            batch = torch.from_numpy(host).to(self.device)
            mine = batch if part is None else torch.from_numpy(
                np.ascontiguousarray(part)).to(self.device)
            out.append(self._bpds(self.eval_step(mine)[1]))
            if codec is not None:
                try:
                    blobs, info = codec.compress(batch)
                    rec = codec.decompress(blobs, info, fetch=True)
                    errors += int(np.sum(rec != host))
                    real_bpds.append(codec.real_bpd(blobs, info))
                except ValueError:
                    # an undecodable container: the whole batch failed
                    errors += int(host.size)
            if self.max_eval_batches and n >= self.max_eval_batches:
                break
        if self.codec is not None:
            self.writer.add_scalar(
                "real bpd",
                float(np.mean(real_bpds)) if real_bpds else float("nan"),
                self.step)
            self.writer.add_scalar("coding errors", errors, self.step)
        return tuple(float(np.mean([o[i] for o in out])) for i in range(3))

    @torch.no_grad()
    def sample_images(self, batch: int = 4,
                      temperatures=(0.25, 0.5, 0.75, 1.0)):
        """{temperature: [batch, H, W, C] numpy samples}, from one draw of
        logistic noise per level scaled by each temperature."""
        c = self.cfg
        r = latent_shapes(c.rough)[0]
        f = latent_shapes(c.fine)[0]
        tiles = (c.Hp // c.fine.H) * (c.Wp // c.fine.W)
        noises = []
        for s in (r, (f[0], f[1], f[2] * tiles)):
            zero = torch.zeros((batch,) + tuple(s), device=self.device)
            noises.append(dlogistic_sample(zero, zero, c.nbits,
                                           self.sample_gen))
        return {t: self.model.sample_from_noise([n * t for n in noises])
                .cpu().numpy() for t in temperatures}

    # -- main loop --------------------------------------------------------

    def train(self):
        clock = StepClock()
        while self.step < self.max_step:
            self.step += 1
            host = np.asarray(next(self.trainloader))
            if self.mesh is not None:
                host = local_batch(host, self.trainloader, self.mesh)
            batch = to_device(torch.from_numpy(np.ascontiguousarray(host)),
                              self.device)
            _, aux = self.train_step(batch)
            if self.step % self.log_every == 0:
                # the loss fetch syncs the host, at the log cadence only
                bpd, bpd1, bpd2 = self._bpds(aux)
                self.writer.add_scalar("train bpd", bpd, self.step)
                self.writer.add_scalar("train bpd 1", bpd1, self.step)
                self.writer.add_scalar("train bpd 2", bpd2, self.step)
                step_s = clock.tick(self.log_every)
                if step_s is not None:
                    self.writer.add_scalar("step time s", step_s, self.step)

            if self._at_interval(self.evaluate_interval):
                tb, tb1, tb2 = self.evaluate()
                self.writer.add_scalar("test bpd", tb, self.step)
                self.writer.add_scalar("test bpd 1", tb1, self.step)
                self.writer.add_scalar("test bpd 2", tb2, self.step)
                if is_lead(self.mesh):
                    for t, img in self.sample_images().items():
                        self.writer.add_image_grid(f"t={t}", img, self.step)
                clock.reset()
            if self._at_interval(self.save_interval):
                self.save()
                clock.reset()
        self.save()

    def _at_interval(self, interval: int) -> bool:
        return at_interval(self.step, self.step_per_epoch, interval)
