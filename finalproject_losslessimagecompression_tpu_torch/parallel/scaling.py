"""Scaling-efficiency harness (north star: >=85% from 1 to N devices).

Measures sharded-train-step throughput over sub-meshes of 1, 2, ... ranks
and reports efficiency.  Every rank of an initialised group calls it;
rank 0's times are the result, returned on every rank.  On the card each
timed window is CUDA events around `steps` steps, ended by a synchronize;
on the CPU, the host clock around steps ended by a loss fetch.

Collective time is measured where it happens.  Under NCCL a captured
step's all_reduce is replayed inside the CUDA graph, and an eager one only
enqueues from the host, so the mesh's host count sees nothing of the
transfer: `collective_device_ms` is the NCCL kernels' device time in one
profiled window.  Under gloo the collectives run on the host (staged
there from a card), and `collective_host_ms` is the mesh's host seconds
in them.  Either is read per step over up to PROFILED_STEPS more steps
after the timed ones (`utils.profiling.collective_ms`), and only the one
that was measured is written.
"""

from __future__ import annotations

import copy
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.idflow import IDFlow
from ..train.optim import build_optimizer
from ..utils.profiling import collective_ms
from .mesh import make_mesh, mesh_shape_for
from .sharding import make_sharded_train_step

PROFILED_STEPS = 3  # a flagship step traces ~20,000 kernels


def _timed_steps(step, x, steps: int, device: torch.device) -> float:
    """Seconds per step over `steps` steps."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(steps):
            step(x)
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / 1e3 / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(x)
    float(loss)
    return (time.perf_counter() - t0) / steps


def measure_scaling(
    model: IDFlow,
    per_device_batch: int = 2,
    steps: int = 5,
    device_counts: Optional[List[int]] = None,
    seed: int = 0,
    mode: str = "weak",
) -> Dict[int, Dict[str, float]]:
    """mode="weak": per-device batch held constant (global batch grows with
    N); efficiency = throughput_N / (N * throughput_1).  The meaningful
    measurement where each rank has a card of its own.

    mode="overhead": GLOBAL batch held constant (per_device_batch * max N)
    while the mesh grows; efficiency = throughput_N / throughput_1.  Where
    ranks share cores or a card, weak scaling is capped by the shared
    hardware, and this isolates what such a run can honestly show: the
    cost of sharding and of the collectives (gloo's host staging included)
    at fixed total compute (1.0 = the machinery adds nothing).

    Each sub-mesh trains a copy of `model` with Adamax 1e-3 on the same
    seeded batch.  Collective time per step: `collective_device_ms` under
    NCCL, `collective_host_ms` under gloo (module docstring)."""
    if mode not in ("weak", "overhead"):
        raise ValueError(f"mode {mode!r}: weak or overhead")
    cfg = model.cfg
    everyone = make_mesh(device=model.device)
    world = everyone.size
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    if max(device_counts) > world:
        raise ValueError(f"device counts {device_counts} exceed the "
                         f"{world} ranks")
    rng = np.random.default_rng(seed)
    global_batch = per_device_batch * max(device_counts)

    results: Dict[int, Dict[str, float]] = {}
    base = None
    for nd in device_counts:
        B = global_batch if mode == "overhead" else per_device_batch * nd
        x = torch.from_numpy(
            np.round(rng.uniform(0, 1, (B, cfg.H, cfg.W, cfg.C)) * 256)
            .astype(np.float32) / 256.0).to(model.device)
        mesh = make_mesh(mesh_shape_for(nd), ranks=range(nd),
                         device=model.device)
        if mesh is not None:
            m = copy.deepcopy(model)
            opt = build_optimizer(m.parameters(),
                                  {"name": "Adamax", "lr": 1e-3}, None, 1)
            step = make_sharded_train_step(m, opt, mesh)
            # two untimed steps: the first runs eagerly (allocator, cuDNN
            # handles), the second captures the step where it is captured
            for _ in range(2):
                float(step(x))
            dt = _timed_steps(step, x, steps, model.device)
            ips = B / dt
            if base is None:
                base = ips if mode == "overhead" else ips / nd
            results[nd] = {
                "images_per_s": ips,
                "efficiency": (ips / base if mode == "overhead"
                               else ips / (base * nd)),
                "step_ms": dt * 1e3,
            }
            n = min(steps, PROFILED_STEPS)
            results[nd].update(collective_ms(
                mesh, lambda: [step(x) for _ in range(n)], n))
            # the step and its graph form a reference cycle: collect it, so
            # that its graph and memory pool go before the next capture
            del m, opt, step
            gc.collect()
            if model.device.type == "cuda":
                torch.cuda.empty_cache()
        everyone.agree(True)  # the next sub-mesh starts together
    return everyone.all_gather_object(results)[0]
