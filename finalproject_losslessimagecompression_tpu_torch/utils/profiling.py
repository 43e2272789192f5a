"""Timing and FLOP accounting for the trainer.

- `PhaseTimer`: accumulating host wall-clock spans with a report and a
  one-line summary.
- `StepClock`: host seconds per training step between log points.
- `fence(device)`: `torch.cuda.synchronize()` on the card (PyTorch returns
  before the device finishes, so a timed region must end in one), nothing
  on the CPU.
- `step_flops(fn)`: runs fn once under `FlopCounterMode` and returns its
  result and the FLOPs of the matrix products and convolutions it ran
  (forward and backward; elementwise work is not counted).
- `device_peak_tflops(dtype)`: the peak of the arithmetic a step really
  runs on an H100 SXM (NVIDIA's data sheet, dense): float32 runs on the
  CUDA cores at 67 TFLOP/s (the trainer's codec pins TF32 off), bfloat16
  989.  None off the card or on another card.
- `device_trace(logdir)`: a torch.profiler context over a block (host
  operations and, on the card, its kernels) that writes a Chrome trace.
- `kernel_times(prof)`: a profile's device kernels by name (time and
  launches), read from the profiler's raw events.
- `profile_busy(run, unprofiled_wall, want)`: one profiled call of run()
  on the card: its kernels, the device's busy seconds, its idle share of
  the wall, and the rANS launches the profiler recorded.
- `collective_ms(mesh, run, steps)`: collective time per step, the NCCL
  kernels' device time over NCCL, the mesh's host seconds over gloo.
- `device_label(device)`: the card as nvidia-smi names it (its name and
  power limit), for every recorded result.

The JAX package's `enable_compile_cache` (XLA's persistent compilation
cache) has no counterpart here: eager PyTorch compiles no program, and the
port's native libraries are already built once per source hash into the
package's `build/` (`codec/native.py`).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional, Tuple

import torch


def fence(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def summary(self) -> str:
        return "  ".join(
            f"{k}: {v['total_s']:.3f}s/{v['count']}"
            for k, v in sorted(self.report().items())
        )


class StepClock:
    """Seconds per step between log points.  `tick(steps)`, called where
    the host has just synced with the device (a loss fetch), returns the
    host seconds per step since the previous tick, None at the first;
    `reset()` after work that is not training (eval, checkpoints)."""

    def __init__(self):
        self.last = None

    def tick(self, steps: int) -> Optional[float]:
        now = time.time()
        last, self.last = self.last, now
        return None if last is None else (now - last) / steps

    def reset(self) -> None:
        self.last = None


def step_flops(fn) -> Tuple[object, int]:
    """(fn(), FLOPs counted while it ran)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, int(counter.get_total_flops())


# H100 SXM dense peaks in TFLOP/s by compute dtype (NVIDIA's data sheet)
_H100_PEAK_TFLOPS = {"float32": 67.0, "bfloat16": 989.0}


def device_peak_tflops(device, dtype: str = "float32"
                       ) -> Tuple[Optional[float], Optional[str]]:
    """(peak TFLOP/s, which peak) of the card for a step computing in
    `dtype`; (None, None) off the card or on a card not in the table."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, None
    name = torch.cuda.get_device_name(device)
    if "H100" not in name or "PCIe" in name:
        return None, None
    return _H100_PEAK_TFLOPS[dtype], f"H100 SXM {dtype} dense"


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[object]:
    """torch.profiler over the block -- host operations, and the card's
    kernels where CUDA is available -- yielding the profiler; its Chrome
    trace (chrome://tracing, Perfetto) is written to logdir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# the port's rANS kernels (csrc/rans_kernels.cu), as the profiler names them
RANS_KERNELS = ("rans_cdf_prepass_kernel", "rans_encode_kernel",
                "rans_decode_kernel")


def kernel_times(prof):
    """[(kernel name, device us, launches)] of a profile, most time first.
    Kernels only: operator entries carry their kernels' time as well, and a
    user annotation (`Optimizer.step#Adamax.step`) spans its kernels on the
    device timeline.  Read from the profiler's raw events: building
    `prof.events()` (the operator tree) for a flagship pass's ~85,000
    device events took ~45 s of host time beside an H100
    (chip_profile_read.py compares the two reads)."""
    times, calls = {}, {}
    for e in prof.profiler.kineto_results.events():
        us = (e.end_ns() - e.start_ns()) / 1e3
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation() or us <= 0):
            continue
        times[e.name()] = times.get(e.name(), 0.0) + us
        calls[e.name()] = calls.get(e.name(), 0) + 1
    return sorted(((k, times[k], calls[k]) for k in times),
                  key=lambda kv: -kv[1])


def rans_calls(kernels) -> Dict[str, int]:
    """{rANS kernel: launches recorded} of `kernel_times`' list."""
    return {n: sum(c for name, _, c in kernels if n in name)
            for n in RANS_KERNELS}


def profile_busy(run, unprofiled_wall: float, want=None, label="profile"):
    """torch.profiler (host and card) over one call of run() on the card:
    {"kernels": kernel_times' list, "wall_s", "device_busy_s" (the sum of
    the kernels' device time), "device_idle_share" (1 - busy / the
    profiled wall), "device_idle_share_unprofiled" (1 - busy /
    `unprofiled_wall`, the same work's wall without the profiler),
    "rans_calls", "traces"}.  `want` ({rANS kernel: launches}): the
    launches the profiler must record in the call, replayed graphs
    included.  The profiler has dropped a kernel's records before, so a
    call that records fewer is traced again, three traces at most, and
    then this raises, as it does for more launches than `want` or a trace
    without device time."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            run()
            torch.cuda.synchronize()
            wall = time.time() - t0
        kernels = kernel_times(prof)
        calls = rans_calls(kernels)
        if want is None or calls == want:
            break
        if any(calls[n] > want[n] for n in want):
            raise AssertionError(f"{label}: the profiler recorded {calls} "
                                 f"rANS launches, more than {want}")
    if want is not None and calls != want:
        raise AssertionError(f"{label}: three traces recorded {calls} rANS "
                             f"launches, not {want}")
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    if busy_s <= 0:
        raise AssertionError(f"{label}: the profiler recorded no device time")
    return {"kernels": kernels, "wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
            "device_idle_share_unprofiled": 1.0 - busy_s / unprofiled_wall,
            "rans_calls": calls, "traces": attempt}


def collective_ms(mesh, run, steps: int) -> Dict[str, float]:
    """Collective time per step of the `steps` steps that run() takes:
    {"collective_device_ms": ...} over NCCL, the device time of the NCCL
    kernels in one torch.profiler window of run() (the profiler records
    the kernels of replayed CUDA graphs too: a captured step's all_reduce
    never passes through Python again, and an eager one only enqueues
    from the host); {"collective_host_ms": ...} over gloo, the mesh's host
    seconds in collectives during run().  Raises where the profiler
    recorded no device time at all."""
    if steps < 1:
        raise ValueError(f"collective time over {steps} steps")
    if mesh.backend != "nccl":
        comm0 = mesh.comm_s
        run()
        return {"collective_host_ms": (mesh.comm_s - comm0) / steps * 1e3}
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = kernel_times(prof)
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    return {"collective_device_ms": sum(
        us for name, us, _ in kernels if "nccl" in name.lower())
        / steps / 1e3}


def device_label(device) -> str:
    """'cpu', or the card as `nvidia-smi --query-gpu=name,power.limit`
    gives it (its name and power limit)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if out:
        return out[0]
    return f"{torch.cuda.get_device_name(index)}, power limit not read"
