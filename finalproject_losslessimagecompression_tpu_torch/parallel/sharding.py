"""Data-parallel train and eval steps over a mesh of ranks.

Layout, as in the JAX package (flow and VQ-VAE models are small next to
their activations): parameters are replicated, equal on every rank from a
broadcast of rank 0's; the batch shards over the whole mesh, rank r
taking rows [r*b, (r+1)*b).  Each rank computes the mean loss of its
shard and its gradients; one all_reduce of every gradient and the loss,
divided by D, gives each rank the gradient of the global mean loss (the
shards being equal) and that loss, so the optimizer (the port's
`torch.optim` one, its global-norm clip included) takes the same update
on every rank.  The gradients are reduced with a plain all_reduce of one
flat buffer rather than DistributedDataParallel: the VQ-VAE trainer's
global BatchNorm statistics and dead-code reinit need the collectives in
its own step, and every collective goes through `Mesh`.

A sharded function receives the global batch, the same on every rank,
as the JAX function does (numpy or a tensor), and returns what the JAX
function returns, on every rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.idflow import IDFlow, log_likelihood
from ..utils.graphs import optimizer_step
from .mesh import Mesh, make_mesh


def trainer_mesh(use_mesh: bool, device) -> Optional[Mesh]:
    """The mesh a trainer with `use_mesh` trains over: every rank of an
    initialised process group of more than one rank (the JAX trainers'
    `len(jax.devices()) > 1`), else None, the plain step."""
    if use_mesh and dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh(device=device)
    return None


def is_lead(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes a trainer's files: rank 0 of the mesh
    (the only process without one)."""
    return mesh is None or mesh.rank == 0


def global_mean(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean over the mesh's ranks of a per-rank mean (t itself without
    a mesh)."""
    return t if mesh is None else mesh.all_reduce(t) / mesh.size


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Make every parameter and buffer equal to mesh rank 0's."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            mesh.broadcast_(t)
    return module


def shard_batch(x, mesh: Mesh):
    """This rank's rows of the global batch x: [r*b, (r+1)*b)."""
    B = int(x.shape[0])
    if B % mesh.size:
        raise ValueError(f"batch {B} does not shard over {mesh.size} ranks")
    b = B // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def local_batch(host, loader, mesh: Mesh):
    """This rank's part of a loader's batch.  A loader with `shard: true`
    (shard_count == mesh size) yields the rank's local batch, the global
    batch being the ranks' local batches in rank order (JAX's
    multi-process meaning); an unsharded loader yields the global batch on
    every rank, of which the rank takes its rows (JAX's single-controller
    meaning)."""
    count = getattr(loader, "shard_count", 1)
    if count == mesh.size:
        return host
    if count == 1:
        return shard_batch(host, mesh)
    raise ValueError(f"loader sharded {count} ways over a mesh of "
                     f"{mesh.size} ranks")


def eval_batch(host: np.ndarray, loader, mesh: Optional[Mesh]):
    """(the global batch, this rank's rows of it) of an eval loader's batch,
    the global batch the same on every rank (where the loader is sharded,
    the ranks' local batches gathered in rank order); the rows are None
    without a mesh or where the batch does not divide over the ranks
    (every rank then evaluates the whole batch)."""
    if mesh is None:
        return host, None
    if getattr(loader, "shard_count", 1) == mesh.size:
        host = mesh.all_gather(torch.from_numpy(np.ascontiguousarray(
            host))).reshape(-1, *host.shape[1:]).numpy()
    if host.shape[0] % mesh.size:
        return host, None
    return host, shard_batch(host, mesh)


def graphs_allowed(mesh: Optional[Mesh]) -> bool:
    """Whether a train step over `mesh` can be captured as a CUDA graph:
    without a mesh, or under NCCL (its all_reduce is captured in the
    graph).  Gloo stages every collective through the host after a
    synchronize (`Mesh._to_comm`), so its steps run eagerly."""
    return mesh is None or mesh.backend == "nccl"


def sharded_update(loss: torch.Tensor, optimizer, mesh: Optional[Mesh],
                   lr: torch.Tensor) -> torch.Tensor:
    """Backward of this rank's loss, gradients averaged over the mesh,
    one optimizer update at lr (an element of the step's
    `optimizer.lrs`); returns the global mean loss (detached).  Without a
    mesh, the plain update of the loss.  Device work only: the update
    count is the step's (`Optimizer.advance`).

    A parameter this rank's loss does not reach takes a zero gradient, so
    every rank updates every parameter alike."""
    optimizer.zero_grad()
    if mesh is None:
        loss.backward()
        optimizer.update(lr)
        return loss.detach()
    if loss.requires_grad:
        loss.backward()
    params = optimizer.params
    flat = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in params] + [loss.detach().reshape(1).to(params[0].dtype)])
    flat = mesh.all_reduce(flat) / mesh.size
    pos = 0
    for p in params:
        n = p.numel()
        p.grad = flat[pos:pos + n].view_as(p)
        pos += n
    optimizer.update(lr)
    return flat[-1]


def flow_nll(model: IDFlow, batch, cond, conditional: bool):
    """The mean NLL (nats/dim) of a flow on a batch (with its cond where
    the flow is conditional)."""
    latents, means, logscales = model(batch, cond if conditional else None)
    lp, _ = log_likelihood(model.cfg, latents, means, logscales)
    return -lp.mean()


def _as_device(x, device):
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


class ShardedTrainStep:
    """`step(batch, cond=None)` on the global batch, or `step.local(...)`
    on this rank's shard: one update; returns the global mean loss.  The
    update is a `GraphedStep` (`step.graphed`), captured on the card under
    NCCL and eager under gloo (`graphs_allowed`)."""

    def __init__(self, model: IDFlow, optimizer, mesh: Mesh,
                 conditional: bool = False):
        self.model, self.optimizer, self.mesh = model, optimizer, mesh
        self.conditional = conditional
        replicate(model, mesh)
        self.graphed = optimizer_step(self._body, optimizer, model.device,
                                      graphs=graphs_allowed(mesh))

    def _body(self, batch, cond=None) -> torch.Tensor:
        loss = flow_nll(self.model, batch, cond, self.conditional)
        return sharded_update(loss, self.optimizer, self.mesh,
                              self.optimizer.lrs(1)[0])

    def local(self, batch, cond=None) -> torch.Tensor:
        dev = self.model.device
        return self.graphed(_as_device(batch, dev), _as_device(cond, dev))

    def __call__(self, batch, cond=None) -> torch.Tensor:
        return self.local(shard_batch(batch, self.mesh),
                          None if cond is None else shard_batch(cond,
                                                                self.mesh))


def make_sharded_train_step(model: IDFlow, optimizer, mesh: Mesh,
                            conditional: bool = False) -> ShardedTrainStep:
    return ShardedTrainStep(model, optimizer, mesh, conditional)


def make_sharded_eval_step(model: IDFlow, mesh: Mesh,
                           conditional: bool = False):
    """`eval_step(batch, cond=None)` on the global batch: the global mean
    loss, without gradients."""

    @torch.no_grad()
    def eval_step(batch, cond=None):
        dev = model.device
        loss = flow_nll(model, _as_device(shard_batch(batch, mesh), dev),
                     None if cond is None
                     else _as_device(shard_batch(cond, mesh), dev),
                     conditional)
        return mesh.all_reduce(loss) / mesh.size

    return eval_step
