"""Timing and FLOP accounting for the trainer and the codecs.

- `span(name)`: a program span at a host boundary of a hot path (the
  names the codecs and the captured steps open are listed in the module
  that opens them).  While a torch profiler records, it is a
  `record_function` range, a host event on the profiler's own timeline
  beside the device's kernels; while a `PhaseTimer` collects, its
  seconds are added there too.  Otherwise it is one shared null context.
  Spans nest: the span open around another is its parent.
- `PhaseTimer`: accumulating host spans (`time.perf_counter`) with a
  report and a one-line summary.  Its `phase(name)` is a span that the
  timer always collects, and while it is open the timer also collects
  every span opened inside it, under that span's name.
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
- `profile_busy(run, want)`: one profiled call of run() on the card: its
  kernels, the device's busy seconds (the union of its device intervals
  over the profiled window), its idle share of that window's wall, and
  the rANS launches the profiler recorded.
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
import contextvars
import os
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL = contextlib.nullcontext()
# the PhaseTimers with a phase open around the current code, outermost first
_COLLECTING: contextvars.ContextVar = contextvars.ContextVar(
    "collecting_phase_timers", default=())


def fence(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A program span (module docstring): a context manager.  With no
    profiler recording and no PhaseTimer collecting, one shared null
    context: nothing is entered or allocated."""
    timers = _COLLECTING.get()
    if not timers and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _timed(name, timers, collect=False)


@contextlib.contextmanager
def _timed(name: str, timers: tuple, collect: bool) -> Iterator[None]:
    """The span's body inside a `record_function` range where a profiler
    records; its seconds added to each of `timers`, which collect the
    spans opened inside it where `collect`."""
    token = _COLLECTING.set(timers) if collect else None
    rf = (torch.profiler.record_function(name)
          if _autograd_profiler._is_profiler_enabled else _NULL)
    t0 = time.perf_counter()
    try:
        with rf:
            yield
    finally:
        dt = time.perf_counter() - t0
        if token is not None:
            _COLLECTING.reset(token)
        for timer in timers:
            timer.totals[name] += dt
            timer.counts[name] += 1


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def phase(self, name: str):
        """A span this timer collects, with every span inside it."""
        timers = _COLLECTING.get()
        if self not in timers:
            timers += (self,)
        return _timed(name, timers, collect=True)

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


PROFILED_WINDOW = "profile_busy.window"


def device_intervals(prof) -> List[Tuple[int, int]]:
    """[(start ns, end ns)] of a profile's device operations (kernels and
    copies; not user annotations, which span their kernels on the device
    timeline), read from the profiler's raw events."""
    return [(e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation() and e.end_ns() > e.start_ns()]


def host_window(prof, name: str) -> Optional[Tuple[int, int]]:
    """(start ns, end ns) of the profile's host range `name`, None where
    it has none."""
    for e in prof.profiler.kineto_results.events():
        if e.name() == name and e.device_type() != \
                torch.autograd.DeviceType.CUDA:
            return e.start_ns(), e.end_ns()
    return None


def busy_seconds(intervals: Sequence[Tuple[int, int]], t0: int,
                 t1: int) -> float:
    """Seconds of [t0, t1] (ns) that at least one interval covers: the
    union, so operations that overlap (streams, copies beside kernels)
    count once."""
    total, end = 0, t0
    for s, t in sorted(intervals):
        s, t = max(s, end), min(t, t1)
        if t > s:
            total += t - s
            end = t
    return total / 1e9


def profile_busy(run, want=None, label="profile"):
    """torch.profiler (host and card) over one call of run() on the card,
    inside a host range `PROFILED_WINDOW` that ends in a synchronise:
    {"kernels": kernel_times' list, "wall_s" (the window's host seconds),
    "device_busy_s" (the union of the device intervals inside the
    window), "device_idle_share" (1 - busy / the window), "rans_calls",
    "traces"}.  `want` ({rANS kernel: launches}): the launches the
    profiler must record in the call, replayed graphs included.  The
    profiler has dropped a kernel's records before, so a call that
    records fewer is traced again, three traces at most, and then this
    raises, as it does for more launches than `want` or a trace without
    device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(PROFILED_WINDOW):
                run()
                torch.cuda.synchronize()
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
    t0, t1 = host_window(prof, PROFILED_WINDOW)
    wall = (t1 - t0) / 1e9
    busy_s = busy_seconds(device_intervals(prof), t0, t1)
    if busy_s <= 0:
        raise AssertionError(f"{label}: the profiler recorded no device time")
    return {"kernels": kernels, "wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
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
