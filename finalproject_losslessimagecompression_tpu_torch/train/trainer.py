"""Flow trainer: the JAX package's `Trainer` on PyTorch, and the
functions that make its steps.

One train step is forward, `log_likelihood`, backward, the optimizer's
clip and update.  `make_train_step`, `make_multi_train_step` and
`make_forward` build the JAX package's single-dispatch programs as
`utils.graphs.GraphedStep`s: on the card each is captured once as a CUDA
graph (at its second call; the first runs eagerly and is the capture's
warm-up) and replayed per call, and a block of K steps is one replay; on
the CPU they run eagerly.  The trainer runs blocks of K =
`steps_per_dispatch` steps: the K batches go to the device in one copy
(into the graph's static input), the K steps run as one replay of the
K-step graph (K = 1: the one-step graph) and their losses stay stacked on
the device, and one copy brings the K losses back when the block is
logged.  Intervals must be multiples of K.  As in JAX, a block of K > 1
steps returns its losses only (no per-split aux to print at eval).

Eval computes the test bpd and, with `test_coding`, compresses and
decompresses every eval batch for real through `FlowCodec` (on the card:
the rANS kernels), counting mismatched values and the real coded bpd.  A
container that does not decode (`ValueError`) counts the whole batch as
errors; any other failure raises.  Building the codec pins the process to
deterministic float32 cuDNN with TF32 off (`models/exact.py`), so training
runs under the same arithmetic contract as the codec.

With `use_mesh: true` in an initialised process group of more than one
rank (parallel/mesh.py: init_distributed), every step is data-parallel
(parallel/sharding.py: the gradients and the loss all_reduced over the
ranks) and eval coding goes through `ShardedFlowCodec`, each rank coding
its shard, when the eval batch divides over the ranks.  A loader with
`shard: true` yields the rank's local batch and the global batch is the
ranks' local batches in rank order (JAX's multi-process meaning); an
unsharded loader yields the global batch on every rank, which takes its
rows (JAX's single-controller meaning).  Rank 0 alone writes checkpoints
and metrics (the parameters are equal on every rank).  With one rank,
`use_mesh` runs the plain step, as in the JAX package.  Steps over a
gloo mesh run eagerly (`parallel.sharding.graphs_allowed`: gloo stages
every collective through the host), and the trainer says so.

The trainer runs on the card unless the caller passes device="cpu".
Checkpoints hold {params, opt_state, step}; a resume whose step is not a
multiple of K realigns the step down (the optimizer's own update count,
which drives the learning rate, is restored as saved).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..convert import params_from_flax
from ..data import loader as _loader  # noqa: F401  (registers loaders)
from ..models.config import FlowCfg, latent_shapes
from ..models.exact import FlowCodec
from ..models.idflow import IDFlow, log_likelihood, resolve_device
from ..ops.dlogistic import dlogistic_sample
from ..parallel.flow_codec import ShardedFlowCodec
from ..parallel.sharding import (
    eval_batch,
    flow_nll,
    global_mean,
    graphs_allowed,
    is_lead,
    local_batch,
    replicate,
    sharded_update,
    trainer_mesh,
)
from ..registry import DATALOADERS, TRAINERS, build
from ..utils.graphs import GraphedStep, optimizer_step
from ..utils.profiling import PhaseTimer, device_peak_tflops, fence, step_flops
from .checkpoint import restore_train_state, save_checkpoint
from .metrics import MetricsWriter, NullWriter
from .optim import build_optimizer

LN2 = math.log(2.0)


def flow_loss(cfg: FlowCfg, latents, means, logscales):
    """(mean NLL in nats/dim, aux) of a flow's outputs: aux holds the
    per-split bpd and each latent's max and min on the integer grid."""
    lp, per_split = log_likelihood(cfg, latents, means, logscales)
    aux = {
        "per_split_bpd": torch.stack([-s.mean() / LN2 for s in per_split]),
        "max_z": torch.stack([z.max() * 2 ** cfg.nbits for z in latents]),
        "min_z": torch.stack([z.min() * 2 ** cfg.nbits for z in latents]),
    }
    return -lp.mean(), aux


def make_forward(model: IDFlow, conditional: bool = False) -> GraphedStep:
    """forward(batch, cond=None) -> the model's (latents, means,
    logscales), without gradients; one graph replay per call on the
    card."""

    @torch.no_grad()
    def forward(batch, cond=None):
        return model(batch, cond if conditional else None)

    return GraphedStep(forward, model.device)


def make_train_step(model: IDFlow, optimizer, conditional: bool = False,
                    mesh=None):
    """(train_step, eval_step).  train_step(batch, cond=None) makes one
    update of the model and the optimizer in place (torch's counterpart of
    JAX's donation) and returns (loss, aux) on the device; eval_step(batch,
    cond=None) gives (loss, aux) without an update, through
    `make_forward`.  With `mesh` the step takes this rank's shard of the
    global batch (with its cond) and returns the global mean loss and this
    rank's aux."""
    cfg = model.cfg
    forward = make_forward(model, conditional)

    def body(batch, cond=None):
        loss, aux = flow_loss(cfg, *model(batch,
                                          cond if conditional else None))
        loss = sharded_update(loss, optimizer, mesh, optimizer.lrs(1)[0])
        return loss, {k: v.detach() for k, v in aux.items()}

    def eval_step(batch, cond=None):
        return flow_loss(cfg, *forward(batch, cond))

    train_step = optimizer_step(body, optimizer, model.device,
                                graphs=graphs_allowed(mesh))
    return train_step, eval_step


def make_multi_train_step(model: IDFlow, optimizer, length: int,
                          conditional: bool = False,
                          mesh=None) -> GraphedStep:
    """multi(batches [length, B, H, W, C], conds=None) -> losses [length]:
    `length` train steps as one graph (JAX's lax.scan over the step), the
    j-th update at the j-th of the block's learning rates."""

    def body(batches, conds=None):
        lrs = optimizer.lrs(length)
        return torch.stack([
            sharded_update(flow_nll(model, batches[j],
                                    None if conds is None else conds[j],
                                    conditional),
                           optimizer, mesh, lrs[j])
            for j in range(length)])

    return optimizer_step(body, optimizer, model.device, length,
                          graphs=graphs_allowed(mesh))


def eager_rule(trainer, mesh) -> None:
    """Print the one line that says a trainer on the card steps eagerly
    by the rule fixed at its construction (a gloo mesh)."""
    if trainer.device.type == "cuda" and not graphs_allowed(mesh):
        print(f"{type(trainer).__name__}: graphs false: eager steps over "
              f"a {mesh.backend} mesh (collectives staged through the host)")


def rank0_writer(writer_path: str, mesh):
    """The metrics writer of a trainer: rank 0's writes, the others'
    discard."""
    if is_lead(mesh):
        return MetricsWriter(writer_path)
    return NullWriter()


def at_interval(step: int, step_per_epoch: int, interval: int) -> bool:
    """Every epoch before the first interval, then at the interval."""
    return (step % step_per_epoch == 0 and step < interval) or \
        step % interval == 0


@TRAINERS.register(name="Trainer")
class Trainer:
    """Config shape: the `train` subtree of configs/*.yaml."""

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
        test_coding: bool = False,
        seed: int = 0,
        num_streams: int = 4096,
        max_eval_batches: int = 0,
        use_mesh: bool = False,
        log_every: int = 1,
        steps_per_dispatch: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.mesh = trainer_mesh(use_mesh, self.device)
        model = dict(model)
        self.load_path = model.pop("load_path", None)
        self.cfg = FlowCfg.from_ref(model)
        self.model = IDFlow(self.cfg, device=self.device, seed=seed)
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
        self.test_coding = test_coding
        self.num_streams = num_streams
        self.max_eval_batches = max_eval_batches
        self.log_every = max(1, log_every)
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        if self.steps_per_dispatch > 1:
            for name, iv in (
                ("evaluate_interval", evaluate_interval),
                ("save_interval", save_interval),
                ("step_per_epoch", step_per_epoch),
                # without this the loop overshoots max_step by up to K-1
                ("max_step", max_step),
            ):
                if iv % self.steps_per_dispatch:
                    raise ValueError(
                        f"{name}={iv} must be a multiple of "
                        f"steps_per_dispatch={self.steps_per_dispatch}"
                    )
        self.step = 0
        if self.load_path:
            self.restore(self.load_path)
            K = self.steps_per_dispatch
            if K > 1 and self.step % K:
                # a step not congruent 0 mod K would put every interval
                # check (all multiples of K) off phase: realign DOWN
                # (re-runs up to K-1 training steps)
                old = self.step
                self.step -= self.step % K
                print(f"resume: step {old} realigned to {self.step} "
                      f"(steps_per_dispatch={K} blocks)")
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        self.train_step, self.eval_step = make_train_step(
            self.model, self.optimizer, mesh=self.mesh)
        self.train_multi = None
        if self.steps_per_dispatch > 1:
            self.train_multi = make_multi_train_step(
                self.model, self.optimizer, self.steps_per_dispatch,
                mesh=self.mesh)
        self.graphs = self.train_step.graphs
        eager_rule(self, self.mesh)
        self.codec = FlowCodec(self.model, num_streams=self.num_streams)
        self.sharded_codec = (None if self.mesh is None
                              else ShardedFlowCodec(self.codec, self.mesh))
        self.sample_gen = torch.Generator(device=self.device).manual_seed(
            seed + 1)

    # -- checkpointing ----------------------------------------------------

    def _state(self):
        return {
            "params": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
        }

    def save(self, path: Optional[str] = None):
        if is_lead(self.mesh):
            save_checkpoint(path or self.save_path, self._state())

    def restore(self, path: str):
        st = restore_train_state(path, self.model, self.optimizer,
                                 params_from_flax)
        self.step = int(st["step"])

    # -- steps ------------------------------------------------------------

    def loss_fn(self, batch: torch.Tensor):
        """(mean NLL in nats/dim, aux) of an NHWC batch on the device, with
        gradients (the train step's loss, run eagerly)."""
        return flow_loss(self.cfg, *self.model(batch))

    # train_step(batch) and eval_step(batch) are make_train_step's (set in
    # __init__): one update returning (loss, aux) on the device, no host
    # sync (over a mesh: this rank's shard, the global mean loss and this
    # rank's aux); (loss, aux) without an update

    def _global_aux(self, aux):
        """The last step's aux over the global batch."""
        if self.mesh is None:
            return aux
        return {"per_split_bpd": global_mean(aux["per_split_bpd"], self.mesh),
                "max_z": self.mesh.all_reduce(aux["max_z"], "max"),
                "min_z": self.mesh.all_reduce(aux["min_z"], "min")}

    def train_block(self, batches: torch.Tensor):
        """One step per batch of a [K, B, H, W, C] block, as one replay of
        the K-step graph; returns (the K losses stacked, the step's aux
        where K = 1, else None), on the device, with no host sync."""
        if self.train_multi is None:
            loss, aux = self.train_step(batches[0])
            return loss[None], aux
        return self.train_multi(batches), None

    def next_block(self, K: int) -> torch.Tensor:
        """K train batches as one [K, B, H, W, C] tensor on the device, in
        one copy (over a mesh: this rank's part of each), into the K-step
        graph's static input where it has one."""
        batches = [np.asarray(next(self.trainloader)) for _ in range(K)]
        if self.mesh is not None:
            batches = [local_batch(b, self.trainloader, self.mesh)
                       for b in batches]
        host = torch.from_numpy(np.stack(batches))
        if self.device.type != "cuda":
            return host.to(self.device)
        dst = (self.train_multi.static_input(0, host)
               if self.train_multi is not None
               else torch.empty(host.shape, device=self.device))
        return dst.copy_(host.pin_memory(), non_blocking=True)

    # -- eval -------------------------------------------------------------

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.device)

    def evaluate(self):
        timer = PhaseTimer()
        bpds, real_bpds, errors = [], [], 0
        n_batches = 0
        warm = False
        for host in iter(self.testloader):
            # over a mesh every rank holds the global batch, evaluates its
            # rows and codes them through the sharded codec
            host, local = eval_batch(host, self.testloader, self.mesh)
            codec = self.codec if local is None else self.sharded_codec
            batch = self._to_device(host)
            part = batch if local is None else self._to_device(local)
            if not warm:
                # cuDNN handles, the allocator and, on the card, the
                # forward's eager first call and capture, outside the timed
                # phase
                self.eval_step(part)
                self.eval_step(part)
                fence(self.device)
                warm = True
            with timer.phase("forward"):
                loss, _ = self.eval_step(part)
                # a host copy: the phase's fence
                loss_v = float(global_mean(loss, self.mesh))
            bpds.append(loss_v / LN2)
            if self.test_coding:
                try:
                    with timer.phase("encode"):
                        blobs, info = codec.compress(batch)
                    with timer.phase("decode"):
                        rec = codec.decompress(blobs, info, fetch=True)
                    errors += int(np.sum(rec != host))
                    real_bpds.append(codec.real_bpd(blobs, info))
                except ValueError:
                    # an undecodable container: the whole batch failed
                    # (over a mesh, on every rank)
                    errors += int(host.size)
            n_batches += 1
            if self.max_eval_batches and n_batches >= self.max_eval_batches:
                break
        rep = timer.report()
        out = {
            "test_bpd": float(np.mean(bpds)) if bpds else float("nan"),
            "forward_time": rep.get("forward", {}).get("total_s", 0.0),
        }
        if self.test_coding:
            out["real_bpd"] = (
                float(np.mean(real_bpds)) if real_bpds else float("nan")
            )
            out["coding_errors"] = errors
            out["coding_time"] = (
                rep.get("encode", {}).get("total_s", 0.0)
                + rep.get("decode", {}).get("total_s", 0.0)
            )
            out["phase_report"] = rep
        return out

    @torch.no_grad()
    def sample_images(self, batch: int = 16, temperatures=(0.25, 0.5, 0.75)):
        noises = []
        for s in latent_shapes(self.cfg):
            zero = torch.zeros((batch,) + tuple(s), device=self.device)
            noises.append(dlogistic_sample(zero, zero, self.cfg.nbits,
                                           self.sample_gen))
        return {
            t: self.model.sample_from_noise([n * t for n in noises])
            .cpu().numpy()
            for t in temperatures
        }

    # -- main loop --------------------------------------------------------

    def train(self):
        """Main loop; on any exception or interrupt a rescue checkpoint is
        written beside save_path, so a long run always resumes."""
        try:
            self._train_loop()
        except BaseException:
            try:
                self.save(self.save_path + ".rescue")
                print(f"rescue checkpoint: {self.save_path}.rescue "
                      f"(step {self.step})")
            except Exception as err:  # the original error matters more
                print(f"rescue checkpoint failed: {err!r}")
            raise

    def _log_rate(self, step_s: float, flops: int, peak) -> None:
        self.writer.add_scalar("step time s", step_s, self.step)
        if flops and step_s > 0:
            tf = flops / step_s / 1e12
            self.writer.add_scalar("achieved tflops", tf, self.step)
            if peak:
                self.writer.add_scalar("mfu pct", 100.0 * tf / peak,
                                       self.step)

    def _train_loop(self):
        K = self.steps_per_dispatch
        # losses come back every `period` blocks of K steps: every
        # log_every steps when log_every is a multiple of K
        period = max(1, self.log_every // K)
        flops = None
        peak, peak_name = device_peak_tflops(self.device,
                                             self.cfg.couple.nn.dtype)
        if peak:
            print(f"mfu denominator: {peak_name}, {peak} TFLOP/s")
            self.writer.add_scalar("mfu peak tflops", peak, 0)
        last_sync = None
        aux = None
        while self.step < self.max_step:
            batches = self.next_block(K)
            if flops is None:
                # FLOPs of one step, counted over the first block (its K
                # steps have the same shapes)
                (losses, aux), block_flops = step_flops(
                    lambda: self.train_block(batches))
                flops = block_flops // K
                self.writer.add_scalar("flops per step", flops, 0)
            else:
                losses, aux = self.train_block(batches)
            self.step += K
            if (self.step // K) % period == 0:
                ls = losses.cpu().numpy()  # ONE sync per block
                for j, lv in enumerate(ls):
                    s = self.step - K + 1 + j
                    self.writer.add_scalar("train loss", float(lv), s)
                    self.writer.add_scalar("train bpd", float(lv) / LN2, s)
                now = time.time()
                if last_sync is not None:
                    self._log_rate((now - last_sync) / (period * K), flops,
                                   peak)
                last_sync = now

            if self._at_interval(self.evaluate_interval):
                if aux is not None:  # blocks of K > 1 carry losses only
                    aux = self._global_aux(aux)
                    for i, (mx, mn, sb) in enumerate(zip(
                            *(aux[k].cpu().numpy()
                              for k in ("max_z", "min_z", "per_split_bpd")))):
                        print(f"split_id: {i} , max_z : {mx} , min_z : {mn} "
                              f", bpd_for_split : {sb}")
                ev = self.evaluate()
                self.writer.add_scalar("test bpd", ev["test_bpd"], self.step)
                if self.test_coding:
                    if np.isfinite(ev.get("real_bpd", float("nan"))):
                        self.writer.add_scalar(
                            "real bpd", ev["real_bpd"], self.step
                        )
                    self.writer.add_scalar(
                        "coding errors", ev["coding_errors"], self.step
                    )
                if is_lead(self.mesh):
                    for t, img in self.sample_images().items():
                        self.writer.add_image_grid(f"t={t}", img, self.step)

            if self._at_interval(self.save_interval):
                self.save()
        self.save()

    def _at_interval(self, interval: int) -> bool:
        return at_interval(self.step, self.step_per_epoch, interval)
