"""What the drivers share: the cell a run measures, the outcome it
reports, the reading the per-layer metrics take their numbers from, and
the helpers that build the program under test from the benchmark's seeded
weights through the package's public entry points."""

from __future__ import annotations

import copy
import gc
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .data import natural_images, seeded_weights
from .reduce import Trace
from .reference.flow import Arch, arch, param_shapes, pin_float32
from .reference.rans import HEADER, plan_steps
from .reference.vqvae import shapes as vq_shapes

WINDOW_SPAN = "lic_bench.traced_window"


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # perf_counter at process start
    rank: int = 0  # this process's rank where the cell spans cards
    port: int = 0  # the ranks' rendezvous port on localhost (0: unset)

    def elapsed(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - self.t_start

    @property
    def flow_config(self) -> dict:
        """The flow's published entry (`model`, or a residual codec's
        `flows`)."""
        return self.config.get("model") or self.config["flows"]

    def arch(self) -> Arch:
        return arch(self.flow_config)

    def weights(self) -> Dict[str, torch.Tensor]:
        """The benchmark's weights of this cell's flow, from the seed."""
        return seeded_weights(param_shapes(self.arch()), self.seed,
                              self.device)

    def vq_weights(self) -> Dict[str, torch.Tensor]:
        """The benchmark's weights of this cell's VQ-VAE, from the seed."""
        return seeded_weights(vq_shapes(self.config["vqvae"]), self.seed,
                              self.device, stream=1)

    def program_flow(self, weights):
        """The program's IDFlow with the benchmark's weights loaded."""
        from finalproject_losslessimagecompression_tpu_torch.models.config \
            import FlowCfg
        from finalproject_losslessimagecompression_tpu_torch.models.idflow \
            import IDFlow

        cfg = FlowCfg.from_ref(copy.deepcopy(self.flow_config))
        model = IDFlow(cfg, device=self.device, seed=self.seed)
        model.load_state_dict(weights, strict=True)
        pin_float32()
        return model.eval()

    def program_vqvae(self, weights):
        """The program's VQ-VAE with the benchmark's weights loaded."""
        from finalproject_losslessimagecompression_tpu_torch.models.vqvae \
            import build_vqvae_from_ref

        vq = build_vqvae_from_ref(copy.deepcopy(self.config["vqvae"]),
                                  device=self.device, seed=self.seed)
        vq.load_state_dict(weights, strict=True)
        return vq.eval()


@dataclass
class Reading:
    """What a traced run hands the per-layer metrics' readers."""

    trace: Trace
    spans: Dict[str, List[float]]
    passes: int  # passes (or calls) inside the trace
    window_s: float  # the measured window's seconds
    windows: int  # passes (or calls) in the measured window
    flops_per_pass: float = 0.0
    rans_bytes_per_pass: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)


@dataclass
class Outcome:
    setup_s: float
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    reading: Optional[Reading] = None
    checks: Dict[str, List[float]] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)

    def check(self, numbers: Dict[str, float], limits: Dict[str, float]):
        """Each number with a limit is compared, beside its limit (a number
        passes at or under it); a number without one is kept as a note,
        printed and not judged.  A limit without its number is refused."""
        missing = sorted(set(limits) - set(numbers))
        if missing:
            raise KeyError(f"no number for the limits {missing}")
        for name, value in numbers.items():
            if name in limits:
                self.checks[name] = [float(value), float(limits[name])]
            else:
                self.notes[name] = value

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks) and all(
            np.isfinite(v) and v <= lim for v, lim in self.checks.values()))


def batches(seed: int, start: int, count: int, batch: int, size):
    """`count` batches of `batch` seeded images, host float32 NHWC."""
    x = natural_images(seed, start, count * batch, size)
    return [x[i * batch:(i + 1) * batch] for i in range(count)]


def container_shapes(blobs_per_batch):
    """(S, k, words) of each container (level blobs per batch)."""
    out = []
    for blobs in blobs_per_batch:
        for b in blobs:
            _, n, S, _, W, _ = HEADER.unpack_from(b, 0)
            out.append((S, plan_steps(n, S), W))
    return out


def traced(run: Callable[[], object], device) -> Trace:
    """torch.profiler (host and, on the card, device) over one call of
    run(), synchronised at both ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            run()
            sync()
        wall = time.perf_counter() - t0
    return Trace(prof, wall, WINDOW_SPAN)


def run_ranks(cell: Cell, target: Callable[[Cell], object]):
    """target(cell) on every rank of a cell that spans `cell.chips` cards:
    ranks 1.. in spawned processes of their own, rank 0 in this one, each
    on its own card (on the CPU, all on the CPU).  Returns rank 0's result
    once every rank has ended; a rank that failed raises."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    def on(r):
        dev = (torch.device("cuda", r) if cell.device.type == "cuda"
               else cell.device)
        return replace(cell, rank=r, port=port, device=dev)

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(on(r),))
             for r in range(1, cell.chips)]
    for p in procs:
        p.start()
    try:
        out = target(on(0))
    finally:
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks ended with exit codes {bad}")
    return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
