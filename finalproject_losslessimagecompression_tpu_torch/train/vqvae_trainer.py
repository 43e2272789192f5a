"""VQ-VAE trainer: the JAX package's `VQVAETrainer` on PyTorch.

Loss = alpha * reconstruction NLL + VQ loss, on inputs scaled to [-1, 1];
the reconstruction NLL is the config's distribution (Binomial by default,
`ops/distributions.py`).  With BatchNorm the step normalises with batch
statistics and updates the running averages by flax's rule
(`models.layers.BatchNorm`).  Dead-code reinitialisation runs every step as
the pure `vq_reinit` on the device, with no host sync; whether it fired is
fetched only at the `log_every` cadence, where the losses are fetched too.
The usage counts are trainer state: checkpoints hold {params, opt_state,
step, counts}, so a resume restores them.

A training step (`update`: the update, the usage counts and the dead-code
reinit) is one `utils.graphs.GraphedStep`: on the card it is captured as
a CUDA graph at its second call and replayed after, with the counts, the
codebook, the BatchNorm running averages and the replaced-codeword count
updated in place; `train_step` alone (the update without the counts) is
one too.  Over a gloo mesh the steps run eagerly
(`parallel.sharding.graphs_allowed`).

With `use_mesh: true` over several ranks (see train/trainer.py for the
batch and checkpoint conventions) the step reduces over the global batch
as the JAX package's sharded step does: the BatchNorm batch moments are
all_reduced sums (so the running averages are global too), the usage
counts are all_reduced, and the encoder outputs that feed the dead-code
reinit are all_gathered in rank order, so every rank applies the same
reinit to the same global array.

The trainer runs on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..codec.interleaved import to_device
from ..convert import vqvae_params_from_flax
from ..data import loader as _loader  # noqa: F401  (registers loaders)
from ..models.idflow import resolve_device
from ..models.layers import BatchNorm
from ..models.vqvae import build_vqvae_from_ref, vq_reinit, vqvae_reinit_params
from ..ops import distributions as _distributions  # noqa: F401  (registers)
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
from ..registry import DATALOADERS, DISTRIBUTIONS, TRAINERS, build
from ..utils.graphs import optimizer_step
from ..utils.profiling import StepClock
from .checkpoint import restore_train_state, save_checkpoint
from .optim import build_optimizer
from .trainer import at_interval, eager_rule, rank0_writer

LN2 = math.log(2.0)


@TRAINERS.register(name="VQVAETrainer")
class VQVAETrainer:
    """Config shape: the `train` subtree of configs/vqvae_for_*.yaml."""

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
        train_args: Optional[dict] = None,
        seed: int = 0,
        max_eval_batches: int = 0,
        use_mesh: bool = False,
        log_every: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.mesh = trainer_mesh(use_mesh, self.device)
        model = dict(model)
        self.load_path = model.pop("load_path", None)
        self.reinit_interval, self.threshold = vqvae_reinit_params(model)
        self.model = build_vqvae_from_ref(model, device=self.device,
                                          seed=seed)
        self.dist = DISTRIBUTIONS.get(self.model.distribution)()
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

        train_args = dict(train_args or {})
        self.alpha = train_args.pop("alpha", 1.0)
        self.beta = train_args.pop("beta", 0.25)
        self.gamma = train_args.pop("gamma", 1.0)
        self.counts = torch.zeros(self.model.embed_num, device=self.device)
        # codewords replaced since the trainer was built, on the device
        self.replaced = torch.zeros((), dtype=torch.int64, device=self.device)
        if self.load_path:
            self.restore(self.load_path)
        if self.mesh is not None:
            replicate(self.model, self.mesh)
            for m in self.model.modules():
                if isinstance(m, BatchNorm):
                    m.sum_over_ranks = self.mesh.all_reduce_grad
        graphs = graphs_allowed(self.mesh)
        self.train_step = optimizer_step(self._train_body, self.optimizer,
                                         self.device, graphs=graphs)
        self.update_step = optimizer_step(self._update_body, self.optimizer,
                                          self.device, graphs=graphs)
        self.graphs = self.update_step.graphs
        eager_rule(self, self.mesh)

    # -- checkpointing ----------------------------------------------------

    def _state(self):
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "step": self.step, "counts": self.counts}

    def save(self, path: Optional[str] = None):
        if is_lead(self.mesh):
            save_checkpoint(path or self.save_path, self._state())

    def restore(self, path: str):
        st = restore_train_state(path, self.model, self.optimizer,
                                 vqvae_params_from_flax)
        self.step = int(st["step"])
        self.counts.copy_(torch.as_tensor(st["counts"]))

    # -- steps ------------------------------------------------------------

    def loss_fn(self, batch: torch.Tensor):
        """(alpha * recloss + vqloss, recloss, vqloss, counts, flat) of an
        NHWC batch in [0, 1]; BatchNorm (if any) in train mode."""
        out, vqloss, counts, flat = self.model((batch - 0.5) / 0.5, self.beta,
                                               self.gamma, train=True)
        recloss = -self.dist.log_prob(batch, out * 0.5 + 0.5).mean()
        return self.alpha * recloss + vqloss, recloss, vqloss, counts, flat

    def _train_body(self, batch: torch.Tensor):
        """The body of `train_step(batch)`: one update; returns (loss,
        recloss, vqloss, counts, flat) on the device, no host sync.  Over a
        mesh: on this rank's shard, with the global mean loss, the global
        usage counts and the global batch's encoder outputs (recloss and
        vqloss stay this rank's)."""
        loss, recloss, vqloss, counts, flat = self.loss_fn(batch)
        loss = sharded_update(loss, self.optimizer, self.mesh,
                              self.optimizer.lrs(1)[0])
        counts = global_mean(counts, self.mesh)
        if self.mesh is not None:
            flat = self.mesh.all_gather(flat.detach()).reshape(
                -1, flat.shape[-1])
        return (loss, recloss.detach(), vqloss.detach(), counts,
                flat.detach())

    def _update_body(self, batch: torch.Tensor):
        loss, recloss, vqloss, counts, flat = self._train_body(batch)
        self.counts.add_(counts)
        did = nrep = None
        if self.reinit_interval:
            did, nrep = self.reinit(flat)
        return loss, recloss, vqloss, did, nrep

    def update(self, host: np.ndarray):
        """One training step on a loader batch (over a mesh, this rank's
        part of it): the update, the usage counts and the dead-code reinit,
        one graph replay on the card.  Returns (loss, recloss, vqloss, did,
        nrep) on the device (did and nrep None without reinit), no host
        sync."""
        if self.mesh is not None:
            host = local_batch(host, self.trainloader, self.mesh)
        return self.update_step(to_device(
            torch.from_numpy(np.ascontiguousarray(host)), self.device))

    @torch.no_grad()
    def reinit(self, flat: torch.Tensor):
        """Dead-code reinitialisation after a step (`vq_reinit` on the
        accumulated counts and the step's encoder vectors), in place;
        returns (did, replaced) as device scalars."""
        cb = self.model.vq.codebook
        new_cb, new_counts, did, nrep = vq_reinit(
            cb, self.counts, flat, float(self.reinit_interval),
            float(self.threshold))
        cb.copy_(new_cb)
        self.counts.copy_(new_counts)
        self.replaced += torch.where(did, nrep, 0)
        return did, nrep

    @torch.no_grad()
    def eval_recon(self, batch: torch.Tensor):
        """(recloss, reconstruction in [0, 1]) with the running averages."""
        out = self.model.reconstruct((batch - 0.5) / 0.5) * 0.5 + 0.5
        return -self.dist.log_prob(batch, out).mean(), out

    def evaluate(self):
        """(test bpd, the last batch's reconstruction as numpy)."""
        bpds, last = [], None
        for n, host in enumerate(iter(self.testloader), 1):
            host, part = eval_batch(host, self.testloader, self.mesh)
            if part is not None:
                host = part
            batch = torch.from_numpy(np.ascontiguousarray(host)).to(
                self.device)
            recloss, out = self.eval_recon(batch)
            bpds.append(float(global_mean(recloss, self.mesh)) / LN2)
            last = out.cpu().numpy()
            if self.max_eval_batches and n >= self.max_eval_batches:
                break
        return float(np.mean(bpds)) if bpds else float("nan"), last

    # -- main loop --------------------------------------------------------

    def train(self):
        clock = StepClock()
        while self.step < self.max_step:
            self.step += 1
            loss, recloss, vqloss, did, nrep = self.update(
                np.asarray(next(self.trainloader)))
            if self.step % self.log_every == 0:
                # the scalar reads sync the host, so the reinit report rides
                # the log cadence (the reinit itself runs every step)
                if self.reinit_interval and bool(did):
                    print(f"vq re-init: replaced {int(nrep)} codewords")
                rl, vl = (float(v) for v in global_mean(
                    torch.stack([recloss, vqloss]), self.mesh))
                self.writer.add_scalar("train loss", float(loss), self.step)
                self.writer.add_scalar("train recloss", rl, self.step)
                self.writer.add_scalar("train vqloss", vl, self.step)
                self.writer.add_scalar("train bpd", rl / LN2, self.step)
                step_s = clock.tick(self.log_every)
                if step_s is not None:
                    self.writer.add_scalar("step time s", step_s, self.step)

            if self._at_interval(self.evaluate_interval):
                bpd, recon = self.evaluate()
                self.writer.add_scalar("test bpd", bpd, self.step)
                if recon is not None:
                    self.writer.add_image_grid("reconstruct", recon,
                                               self.step)
                clock.reset()
            if self._at_interval(self.save_interval):
                self.save()
                clock.reset()
        self.save()

    def _at_interval(self, interval: int) -> bool:
        return at_interval(self.step, self.step_per_epoch, interval)
