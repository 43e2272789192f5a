"""Residual pipeline trainer: the JAX package's `ResidualTrainer` on
PyTorch.

A frozen VQ-VAE (its weights read from the `{"params": ...}` checkpoint the
VQ-VAE trainer writes) gives a lossy reconstruction; the grid-rounded
residual data - rec is tiled into flow-sized patches and modelled by an
IDFlow, conditioned on the reconstruction's patches for ConditionalFlows.
`nouse_vqvae` trains the flow on the image patches themselves (an
unconditional flow only).  `patch_batch_size` > 0 trains each step on a
subset of that many patches, drawn without replacement from the trainer's
own torch.Generator.

Eval gives the test bpd, decodes the latents back through the inverse flow
(`rec_error`, the norm of what the reconstruction misses) and, with
`test_coding`, compresses and decompresses each eval batch for real: the
conditional flow with the VQ-VAE through `ResidualCodec` (index stream and
residual containers, decoded with no side information), other configs
through `FlowCodec` over the patches (on the card: the rANS kernels).  A
container that does not decode (`ValueError`) counts the whole batch as
errors.  Building the codec pins the process to deterministic float32
cuDNN with TF32 off (`models/exact.py`).

With `use_mesh: true` over several ranks (see train/trainer.py for the
batch and checkpoint conventions) each rank prepares and trains on its
own images; `patch_batch_size` then draws the subset from the global
batch's patches, the same draw on every rank (each rank's patches being
a contiguous run of the image-major global order), and each rank weighs
its selected patches so that the averaged gradient is that of the
subset's mean.  Eval coding of the conditional pipeline goes through
`ShardedResidualCodec` when the eval batch divides over the ranks; the
patch codec's eval runs the global batch on every rank and codes it with
the plain codec, as the JAX trainer does.

A training step (`train_step`: the frozen VQ-VAE's reconstruction, the
patches, the loss, backward and update) is one `utils.graphs.GraphedStep`,
captured on the card as a CUDA graph at its second call and replayed
after.  The `patch_batch_size` draw stays outside the graph: before every
call it is drawn from the trainer's generator, as the eager step draws it,
into a static index tensor the graph reads, so the generator's sequence is
the eager path's.  Over a mesh the steps run eagerly: a rank's share of
the draw has a length that depends on the data.

Losses come back to the host only at the `log_every` cadence.  The trainer
runs on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..codec.interleaved import to_device
from ..convert import params_from_flax, vqvae_params_from_flax
from ..data import loader as _loader  # noqa: F401  (registers loaders)
from ..models.config import FlowCfg
from ..models.exact import FlowCodec
from ..models.idflow import IDFlow, log_likelihood, resolve_device
from ..models.residual_codec import ResidualCodec
from ..models.vqvae import build_vqvae_from_ref
from ..ops.reshape import patch_merge, patch_split
from ..ops.rounding import round_to_grid
from ..parallel.full_codecs import ShardedResidualCodec
from ..parallel.sharding import (
    eval_batch,
    global_mean,
    is_lead,
    local_batch,
    replicate,
    sharded_update,
    trainer_mesh,
)
from ..registry import DATALOADERS, TRAINERS, build
from ..utils.graphs import optimizer_step
from ..utils.profiling import StepClock
from .checkpoint import load_params, restore_train_state, save_checkpoint
from .optim import build_optimizer
from .trainer import at_interval, rank0_writer

LN2 = math.log(2.0)


@torch.no_grad()
def residual_inputs(vqvae, data: torch.Tensor, cfg):
    """data [B, H, W, C] -> (patches, rec_patches, rec): the residual
    against the frozen VQ-VAE's grid-rounded reconstruction, and that
    reconstruction, in the flow's (cfg.H, cfg.W) patches."""
    rec = vqvae.reconstruct((data - 0.5) / 0.5) * 0.5 + 0.5
    rec = round_to_grid(rec, cfg.nbits)
    return (patch_split(data - rec, cfg.H, cfg.W),
            patch_split(rec, cfg.H, cfg.W), rec)


@TRAINERS.register(name="ResidualTrainer")
class ResidualTrainer:
    """Config shape: the `train` subtree of configs/resflow*.yaml."""

    def __init__(
        self,
        flows: dict,
        vqvae: dict,
        input_size,
        train_dataloader: dict,
        test_dataloader: dict,
        patch_batch_size: int,
        optimizer: dict,
        scheduler: dict,
        max_step: int,
        step_per_epoch: int,
        evaluate_interval: int,
        save_interval: int,
        save_path: str,
        writer_path: str,
        nouse_vqvae: bool = False,
        seed: int = 0,
        num_streams: int = 1024,
        max_eval_batches: int = 0,
        test_coding: bool = False,
        use_mesh: bool = False,
        log_every: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.mesh = trainer_mesh(use_mesh, self.device)
        flows = dict(flows)
        self.load_path = flows.pop("load_path", None)
        self.cfg = FlowCfg.from_ref(flows)
        if self.cfg.conditional and nouse_vqvae:
            raise ValueError("conditional flows require the VQ-VAE "
                             "(nouse_vqvae must be false)")
        self.model = IDFlow(self.cfg, device=self.device, seed=seed)
        self.nouse_vqvae = nouse_vqvae
        self.vqvae = None
        if not nouse_vqvae:
            vqvae = dict(vqvae)
            ckpt = vqvae.pop("checkpoint")
            self.vqvae = build_vqvae_from_ref(vqvae, device=self.device)
            self.vqvae.load_state_dict(load_params(
                ckpt, self.device, vqvae_params_from_flax))
            self.vqvae.eval().requires_grad_(False)

        self.input_size = tuple(input_size)
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
        self.patch_batch_size = patch_batch_size
        self.max_eval_batches = max_eval_batches
        self.test_coding = test_coding
        self.log_every = max(1, log_every)
        self.step = 0
        if self.load_path:
            self.restore(self.load_path)
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        self.codec = FlowCodec(self.model, num_streams=num_streams)
        # the conditional flow with the VQ-VAE codes the whole pipeline:
        # the index stream too, decoded with no side information
        self.res_codec = None
        if self.cfg.conditional and not nouse_vqvae:
            self.res_codec = ResidualCodec(self.vqvae, self.codec,
                                           self.input_size)
        self.sharded_res_codec = (
            None if self.res_codec is None or self.mesh is None
            else ShardedResidualCodec(self.res_codec, self.mesh))
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        # the plain step's patch draw, made before each call (`_draw`)
        self._sel = None
        self.train_step = optimizer_step(
            self._train_body, self.optimizer, self.device,
            graphs=self.mesh is None, before=self._draw)
        self.graphs = self.train_step.graphs
        if self.device.type == "cuda" and self.mesh is not None:
            print("ResidualTrainer: graphs false: eager steps over a mesh "
                  "(a rank's share of the patch draw depends on the data)")

    # -- checkpointing ----------------------------------------------------

    def _state(self):
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(), "step": self.step}

    def save(self, path: Optional[str] = None):
        if is_lead(self.mesh):
            save_checkpoint(path or self.save_path, self._state())

    def restore(self, path: str):
        st = restore_train_state(path, self.model, self.optimizer,
                                 params_from_flax)
        self.step = int(st["step"])

    # -- steps ------------------------------------------------------------

    def _prepare(self, data: torch.Tensor):
        """data [B, H, W, C] -> (patches, rec_patches or None, rec or
        None): `residual_inputs`, or the data's own patches without a
        VQ-VAE."""
        cfg = self.cfg
        if self.nouse_vqvae:
            return patch_split(data, cfg.H, cfg.W), None, None
        return residual_inputs(self.vqvae, data, cfg)

    def loss_fn(self, patches: torch.Tensor, rec_patches=None):
        """(mean NLL in nats/dim, aux) of a patch batch."""
        cfg = self.cfg
        latents, means, logscales = self.model(
            patches, rec_patches if cfg.conditional else None)
        lp, per_split = log_likelihood(cfg, latents, means, logscales)
        aux = {
            "per_split_bpd": torch.stack([-s.mean() / LN2
                                          for s in per_split]),
            "max_z": torch.stack([z.max() * 2 ** cfg.nbits
                                  for z in latents]),
            "min_z": torch.stack([z.min() * 2 ** cfg.nbits
                                  for z in latents]),
            "latents": latents,
        }
        return -lp.mean(), aux

    def _select(self, n: int):
        """(this rank's patch indices, the weight of its mean loss) of a
        `patch_batch_size` draw from the n patches of this rank's images.
        Over a mesh the draw is over the global batch's n * D patches, the
        same on every rank, and the weight makes the ranks' averaged
        losses the subset's mean."""
        D = 1 if self.mesh is None else self.mesh.size
        k = min(self.patch_batch_size, n * D)
        sel = torch.randperm(n * D, generator=self.gen,
                             device=self.device)[:k]
        if self.mesh is None:
            return sel, 1.0
        lo = self.mesh.rank * n
        mine = sel[(sel >= lo) & (sel < lo + n)] - lo
        return mine, mine.numel() * D / k

    def _draw(self, data: torch.Tensor) -> None:
        """The plain step's `patch_batch_size` draw from the patches of
        `data`, into the static index tensor its body reads."""
        if not self.patch_batch_size or self.mesh is not None:
            return
        cfg = self.cfg
        n = data.shape[0] * (data.shape[1] // cfg.H) * (data.shape[2] // cfg.W)
        sel, _ = self._select(n)
        if self._sel is None:
            self._sel = torch.empty_like(sel)
        self._sel.copy_(sel)

    def _train_body(self, data: torch.Tensor):
        """The body of `train_step(data)`: one update on an image batch
        (over a mesh, this rank's images); returns (loss, aux) on the
        device, no host sync (over a mesh: the global loss, this rank's
        aux)."""
        patches, rec_patches, _ = self._prepare(data)
        weight = 1.0
        if self.patch_batch_size:
            if self.mesh is None:
                sel = self._sel
            else:
                sel, weight = self._select(patches.shape[0])
            patches = patches[sel]
            if rec_patches is not None:
                rec_patches = rec_patches[sel]
        if patches.shape[0]:
            loss, aux = self.loss_fn(patches, rec_patches)
            aux.pop("latents")
            aux = {k: v.detach() for k, v in aux.items()}
        else:  # no patch of the draw is this rank's
            loss, aux = torch.zeros((), device=self.device), {}
        return sharded_update(loss * weight, self.optimizer, self.mesh,
                              self.optimizer.lrs(1)[0]), aux

    @torch.no_grad()
    def eval_step(self, data: torch.Tensor):
        """(loss, aux with the latents, patches, rec_patches, rec)."""
        patches, rec_patches, rec = self._prepare(data)
        loss, aux = self.loss_fn(patches, rec_patches)
        return loss, aux, patches, rec_patches, rec

    # -- eval -------------------------------------------------------------

    def _code(self, data, host, patches, rec_patches, sharded=False):
        """(coding errors, real bpd) of one batch coded for real.  With
        `sharded` (over a mesh, the batch divided over the ranks) the
        global batch `data` codes through ShardedResidualCodec, and a
        container that does not decode raises ValueError on every rank."""
        if sharded:
            codec = self.sharded_res_codec
            idx_blobs, blobs, info = codec.compress(data)
            dec = codec.decompress(idx_blobs, blobs, info, fetch=True)
            return (int(np.sum(dec != host)),
                    codec.real_bpd(idx_blobs, blobs, info))
        if self.res_codec is not None:
            idx_blob, blobs, info = self.res_codec.compress(data)
            dec = self.res_codec.decompress(idx_blob, blobs, info,
                                            fetch=True)
            return (int(np.sum(dec != host)),
                    self.res_codec.real_bpd(idx_blob, blobs, info))
        blobs, info = self.codec.compress(patches, rec_patches)
        dec = self.codec.decompress(blobs, info, rec_patches, fetch=True)
        return (int(np.sum(dec != patches.cpu().numpy())),
                self.codec.coded_bits(blobs) / float(host.size))

    def evaluate(self):
        H, W = self.input_size
        bpds, real_bpds, errors = [], [], 0
        last, rec_err = {}, float("nan")
        for n, host in enumerate(iter(self.testloader), 1):
            # over a mesh every rank holds the global batch and evaluates
            # its rows
            host, part = eval_batch(host, self.testloader, self.mesh)
            if self.sharded_res_codec is None:
                # the patch codec codes the global batch on every rank, as
                # the JAX trainer does
                part = None
            host = np.ascontiguousarray(host)
            data = torch.from_numpy(host).to(self.device)
            mine = data if part is None else torch.from_numpy(
                np.ascontiguousarray(part)).to(self.device)
            loss, aux, patches, rec_patches, rec = self.eval_step(mine)
            bpds.append(float(global_mean(loss, self.mesh)) / LN2)
            with torch.no_grad():
                gen = patch_merge(
                    self.model.inverse_from_latents(aux["latents"]), H, W)
            rec_img = gen if rec is None else rec + gen
            if part is None:
                rec_err = float(torch.linalg.norm(mine - rec_img))
            else:
                rec_err = float(torch.sqrt(self.mesh.all_reduce(
                    torch.sum((mine - rec_img) ** 2))))
            last = {"data": mine, "rec_img": rec_img}
            if rec is not None:
                last.update(rec=rec, res_dec=gen)
            if self.test_coding:
                try:
                    err, rbpd = self._code(data, host, patches, rec_patches,
                                           part is not None)
                    errors += err
                    real_bpds.append(rbpd)
                except ValueError:
                    # an undecodable container: the whole batch failed
                    # (over a mesh, on every rank)
                    errors += int(host.size)
            if self.max_eval_batches and n >= self.max_eval_batches:
                break
        out = {
            "test_bpd": float(np.mean(bpds)) if bpds else float("nan"),
            "rec_error": rec_err,
            "images": {k: v.cpu().numpy() for k, v in last.items()},
        }
        if self.test_coding:
            out["real_bpd"] = (float(np.mean(real_bpds)) if real_bpds
                               else float("nan"))
            out["coding_errors"] = errors
        return out

    # -- main loop --------------------------------------------------------

    def train(self):
        clock = StepClock()
        while self.step < self.max_step:
            self.step += 1
            host = np.asarray(next(self.trainloader))
            if self.mesh is not None:
                host = local_batch(host, self.trainloader, self.mesh)
            data = to_device(torch.from_numpy(np.ascontiguousarray(host)),
                             self.device)
            loss, _ = self.train_step(data)
            if self.step % self.log_every == 0:
                lv = float(loss)  # the host sync, at the log cadence only
                self.writer.add_scalar("train loss", lv, self.step)
                self.writer.add_scalar("train bpd", lv / LN2, self.step)
                step_s = clock.tick(self.log_every)
                if step_s is not None:
                    self.writer.add_scalar("step time s", step_s, self.step)

            if self._at_interval(self.evaluate_interval):
                self._log_eval(self.evaluate())
                clock.reset()
            if self._at_interval(self.save_interval):
                self.save()
                clock.reset()
        self.save()

    def _log_eval(self, ev):
        self.writer.add_scalar("test bpd", ev["test_bpd"], self.step)
        self.writer.add_scalar("test rec error", ev["rec_error"], self.step)
        if self.test_coding:
            self.writer.add_scalar("coding errors", ev["coding_errors"],
                                   self.step)
            if np.isfinite(ev.get("real_bpd", float("nan"))):
                self.writer.add_scalar("real bpd", ev["real_bpd"], self.step)
        imgs = ev["images"]
        for tag, key in (("original", "data"), ("rec by vqvae", "rec"),
                         ("rec image", "rec_img")):
            if key in imgs:
                self.writer.add_image_grid(tag, imgs[key], self.step)
        if "res_dec" in imgs:
            self.writer.add_image_grid("decoded residual",
                                       imgs["res_dec"] + 0.5, self.step)

    def _at_interval(self, interval: int) -> bool:
        return at_interval(self.step, self.step_per_epoch, interval)
