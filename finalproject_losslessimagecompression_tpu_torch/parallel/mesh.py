"""Process groups as device meshes, the multi-process runtime, and the one
place every collective of the package goes through.

The JAX package has one controller: a process holds a `Mesh` of devices
and `shard_map` / `jit` split a global array over it.  Here there is one
process per device, joined by a `torch.distributed` process group, and a
mesh of D devices is a group of D ranks.  Rank r is device r of the mesh
in row-major order: `data` index r // tile, `tile` index r % tile.  The
VQ codebook shards over `tile` (parallel/vq.py), so the ranks that share
a `data` index form a group of their own.

Collectives.  Gloo's all_gather, gather and reduce take CPU tensors only,
so under gloo a CUDA tensor is staged through the host (`Mesh._to_comm`);
NCCL takes the CUDA tensor itself.  The mesh counts the collectives
Python calls and the host seconds they took (`comm_calls`, `comm_s`).
Under gloo that is the collective time: the staging copies, the transfer
and the wait for the slower rank, the rank's own queued work having been
synchronised before the clock starts.  Under NCCL it is only the time to
enqueue, and a collective replayed inside a captured CUDA graph does not
pass through Python at all, so the scale-out numbers take NCCL's time
from the device instead (`utils.profiling.collective_ms`).

Failures.  A rank that raises while the others wait in a collective
would hang them until the group's timeout, so a check that can fail on
one rank (a corrupt container, a state not back at 2^32) first agrees
across the mesh (`Mesh.check`) and then raises the same ValueError on
every rank.  Every group is made with a timeout, so a hung collective
fails instead of stalling.
"""

from __future__ import annotations

import gc
import math
import os
import socket
import time
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.idflow import resolve_device

DEFAULT_TIMEOUT_S = 600.0
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT")


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Default (data, tile) factorization: tile gets the largest power-of-2
    factor <= sqrt(n), data the rest."""
    tile = 1
    while (
        tile * 2 <= int(math.sqrt(n_devices))
        and n_devices % (tile * 2) == 0
    ):
        tile *= 2
    return n_devices // tile, tile


def _rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: the caller's, or the card of index LOCAL_RANK."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} but {torch.cuda.device_count()} "
                "GPU(s) visible: two ranks would share one GPU; pass "
                "device= with backend='gloo' to share it")
        device = torch.device("cuda", local_rank)
    return device


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     **kwargs) -> torch.device:
    """Join the process group; returns this rank's device.

    Rank, world size and rendezvous come from the standard torchrun
    variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
    or from `rank=`, `world_size=` and `init_method=` / `store=`, which
    are passed on to `init_process_group` with `timeout_s`.  The device is
    the caller's, else the card of index LOCAL_RANK (set as the current
    device); the backend is the caller's, else NCCL on a card and gloo on
    the CPU.  Two ranks share a card only where the caller names it and
    asks for gloo: NCCL refuses that.

    Tolerates exactly one condition, an already initialised group
    (idempotent re-entry); any other failure raises.  Nothing is chosen
    silently: no fallback from NCCL to gloo, none from the card to the
    CPU, none to a single process."""
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", kwargs.get("rank",
                                                      env.get("RANK", 0))))
    if dist.is_initialized():
        return _rank_device(device, local_rank)
    if "rank" not in kwargs:
        missing = [v for v in ("RANK", "WORLD_SIZE") if v not in env]
        if "init_method" not in kwargs and "store" not in kwargs:
            missing += [v for v in ("MASTER_ADDR", "MASTER_PORT")
                        if v not in env]
        if missing:
            raise RuntimeError(
                f"init_distributed: {', '.join(missing)} not set; launch "
                f"with torchrun (which sets {', '.join(_TORCHRUN_VARS)}) "
                "or pass rank=, world_size= and init_method= or store=")
        kwargs["rank"] = int(env["RANK"])
        kwargs["world_size"] = int(env["WORLD_SIZE"])
    device = _rank_device(device, local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s),
                            **kwargs)
    if backend == "nccl":
        # NCCL refuses two ranks on one GPU at its first collective; say
        # which ranks collide before that
        where = (socket.gethostname(), str(torch.cuda.get_device_properties(
            device).uuid))
        seen = [None] * dist.get_world_size()
        dist.all_gather_object(seen, where)
        if len(set(seen)) != len(seen):
            raise RuntimeError(
                f"two ranks share one GPU under NCCL: {seen}; give each "
                "rank its own card, or ask for backend='gloo'")
    return device


def shutdown() -> None:
    """End the process group.  NCCL cannot destroy a communicator while a
    CUDA graph holding one of its collectives is alive (the destroy waits
    on the graph's work: four NCCL ranks hung there), and a captured step
    outlives its last reference (a `GraphedStep` holds its body, a bound
    method of the object that holds the step: a cycle), so garbage is
    collected and the card synchronised first."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """A sum over the mesh whose gradient is the sum of the ranks'
    gradients (every rank's loss depends on the summed value)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous()), None


class Mesh:
    """A (data, tile) mesh of the ranks of a process group.

    `shape` maps each axis name to its size, `rank` is this process's
    index in the mesh and `coords` its (data, tile) coordinates; `group`
    holds every rank of the mesh and `tile_group` the ranks that share
    this rank's `data` index.  `device` is where this rank computes."""

    def __init__(self, shape: Dict[str, int], ranks: Sequence[int], group,
                 tile_group, device: torch.device):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = math.prod(shape.values())
        self.ranks = list(ranks)
        self.group = group
        self.tile_group = tile_group
        self.device = device
        self.backend = dist.get_backend(group)
        self.rank = dist.get_rank(group)
        tile = shape[self.axis_names[-1]]
        self.coords = {self.axis_names[0]: self.rank // tile,
                       self.axis_names[-1]: self.rank % tile}
        self.comm_calls = 0
        self.comm_s = 0.0

    # -- the one place collectives go through ---------------------------

    def _group(self, axis: Optional[str]):
        if axis is None:
            return self.group, self.size
        if axis != self.axis_names[-1]:
            raise ValueError(f"collectives run over the mesh or its "
                             f"{self.axis_names[-1]!r} axis, not {axis!r}")
        return self.tile_group, self.shape[axis]

    def _to_comm(self, t: torch.Tensor) -> torch.Tensor:
        """t on the device the backend needs: the host under gloo (staged
        from the card), the card under NCCL."""
        dev = "cpu" if self.backend == "gloo" else self.device
        return t.detach().to(dev, copy=True).contiguous()

    def _timed(self, fn):
        if self.backend == "gloo" and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the work queued so far
        t0 = time.perf_counter()
        out = fn()
        self.comm_s += time.perf_counter() - t0
        self.comm_calls += 1
        return out

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axis: Optional[str] = None) -> torch.Tensor:
        """The reduction of t over the mesh (or `axis`), on t's device."""
        group, n = self._group(axis)
        if n == 1:
            return t.detach().clone()

        def run():
            buf = self._to_comm(t)
            dist.all_reduce(buf, op=_OPS[op], group=group)
            return buf.to(t.device)

        return self._timed(run)

    def all_reduce_grad(self, t: torch.Tensor) -> torch.Tensor:
        """A differentiable sum of t over the mesh."""
        if self.size == 1:
            return t
        return _AllReduceSum.apply(t, self)

    def all_gather(self, t: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
        """[n, *t.shape]: every rank's t in rank order, on t's device."""
        group, n = self._group(axis)
        if n == 1:
            return t.detach()[None].clone()

        def run():
            buf = self._to_comm(t)
            out = [torch.empty_like(buf) for _ in range(n)]
            dist.all_gather(out, buf, group=group)
            return torch.stack(out).to(t.device)

        return self._timed(run)

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable obj, in rank order."""
        out = [None] * self.size
        self._timed(lambda: dist.all_gather_object(out, obj,
                                                   group=self.group))
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> None:
        """Overwrite t with mesh rank `src`'s t."""
        if self.size == 1:
            return

        def run():
            buf = self._to_comm(t)
            dist.broadcast(buf, src=self.ranks[src], group=self.group)
            with torch.no_grad():
                t.copy_(buf)

        self._timed(run)

    def agree(self, ok: bool) -> bool:
        """True on every rank when ok is true on every rank."""
        flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
        return bool(self.all_reduce(flag, "min")[0])

    def check(self, ok: bool, message: str) -> None:
        """Raise ValueError(message) on every rank unless ok on all."""
        if not self.agree(ok):
            raise ValueError(message)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "tile"), ranks=None,
              device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """A mesh over `ranks` (default: the whole initialised group) of the
    given (data, tile) shape (default: `mesh_shape_for`).

    Every rank of the world calls it, members or not, since making a group
    is collective over the world; a rank outside `ranks` gets None.  The
    device is the caller's, else the current card."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group "
            "(parallel.mesh.init_distributed)")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    n = len(ranks)
    shape = tuple(shape) if shape is not None else mesh_shape_for(n)
    if len(shape) != len(axis_names) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} "
                         f"does not hold {n} ranks")
    timeout = timedelta(seconds=timeout_s)
    group = (dist.group.WORLD if ranks == list(range(world))
             else dist.new_group(ranks, timeout=timeout))
    tile = shape[-1]
    tile_groups = []
    if tile > 1:
        for d in range(n // tile):
            sub = ranks[d * tile:(d + 1) * tile]
            tile_groups.append(group if sub == ranks
                               else dist.new_group(sub, timeout=timeout))
    me = dist.get_rank()
    if me not in ranks:
        return None
    r = ranks.index(me)
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dict(zip(axis_names, (int(s) for s in shape))), ranks, group,
                tile_groups[r // tile] if tile > 1 else None,
                resolve_device(device))
