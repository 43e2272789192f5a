"""Training and eval steps as captured CUDA graphs.

The JAX trainers compile each step, or each block of K steps, into one
program and dispatch it once.  `GraphedStep` is the counterpart here: a
step's body (forward, loss, backward, clip and optimizer update, or an
eval forward) captured once as a CUDA graph and replayed per call.

- On the CPU, and where the step was built with `graphs=False` (a rule
  its trainer fixes at construction: gloo collectives staged through the
  host, a mesh share whose length depends on the data), every call runs
  the body eagerly.
- On the card the first call of an input signature (shapes, dtypes, which
  inputs are None) runs the body eagerly on a side stream: the warm-up a
  capture needs (cuDNN plans, cuBLAS handles, the optimizer's lazily made
  state), which for a train step is a real update, the first.  The second
  call copies its inputs into static tensors, captures the body over them
  and replays the graph once to do its own work (capture executes
  nothing).  Later calls fill the static inputs and replay.  A failed
  capture raises; nothing falls back to the eager body.

A step on the card pins the process to the codec's arithmetic contract
(`models.exact.set_deterministic_cuda`: deterministic cuDNN, no
autotuning, no TF32), so that its eager body and its graph pick the same
kernels.

Host work that must happen at every call, graph or not, runs outside the
body: `before(*args)` (the block's learning rates into a static tensor, a
patch draw into a static index tensor) and `after()` (the optimizer's
update count).  The body must update every piece of state in place and
read nothing back to the host.  A replay's outputs are cloned, so the next
replay does not overwrite what a caller holds.  `eager` is the whole step
without a graph, on the current stream (what a captured step is held
against).  Steps count their captures and capture seconds, replays and
eager calls, and report the bytes of their graphs' memory pool.

Program spans (`utils.profiling.span`), none inside the body: `step.call`
(a call, `eager` included); `step.before` and `step.after`; `step.stage`
(the static inputs' fill, pinning included); `step.replay`, `step.clone`
(the outputs' copy); `step.eager` (the body run eagerly) and
`step.capture`.  A counted event is the span of its name: `replays`,
`eager_calls`, `captures`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..models.exact import set_deterministic_cuda
from .profiling import span


def _signature(args):
    return tuple(None if a is None else (tuple(a.shape), a.dtype)
                 for a in args)


def _cloned(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _cloned(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_cloned(v) for v in out)
    return out


def pool_bytes(pool) -> int:
    """Bytes of the allocator segments of a graph memory pool."""
    if pool is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


class GraphedStep:
    """step(*args) = before(*args); body(*args) (eager, captured or
    replayed); after().  args are tensors or None."""

    def __init__(self, body: Callable, device, graphs: bool = True,
                 before: Optional[Callable] = None,
                 after: Optional[Callable] = None):
        self.body = body
        self.device = torch.device(device)
        self.graphs = graphs and self.device.type == "cuda"
        if self.device.type == "cuda":
            set_deterministic_cuda()
        self.before, self.after = before, after
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.eager_calls = 0
        self.pool = None
        self._seen = set()
        # signature -> (graph, static inputs, static outputs)
        self._graphs = {}

    def eager(self, *args):
        """The step without a graph, on the current stream."""
        with span("step.call"):
            return self._run(lambda: self._eager(lambda: self.body(*args)),
                             args)

    def __call__(self, *args):
        if not self.graphs:
            return self.eager(*args)
        with span("step.call"):
            key = _signature(args)
            if key not in self._graphs and key not in self._seen:
                self._seen.add(key)
                return self._run(lambda: self._eager(
                    lambda: self._on_side_stream(args)), args)
            return self._run(lambda: self._replay(key, args), args)

    def static_input(self, i: int, like: torch.Tensor) -> torch.Tensor:
        """The static tensor of input i of the graph captured for inputs
        like `like` (shape and dtype), where one exists; else a new device
        tensor.  A caller that stages its input there saves the replay's
        copy."""
        for key, (_, inputs, _) in self._graphs.items():
            if key[i] == (tuple(like.shape), like.dtype):
                return inputs[i]
        return torch.empty(like.shape, dtype=like.dtype, device=self.device)

    @property
    def pool_bytes(self) -> int:
        return pool_bytes(self.pool)

    def _run(self, fn, args):
        if self.before is not None:
            with span("step.before"):
                self.before(*args)
        out = fn()
        if self.after is not None:
            with span("step.after"):
                self.after()
        return out

    def _eager(self, run):
        """run(), the body run eagerly: counted in `eager_calls`."""
        with span("step.eager"):
            self.eager_calls += 1
            return run()

    def _replay(self, key, args):
        """Fill the static inputs of the signature's graph (capturing it
        first where there is none) and replay it."""
        if key not in self._graphs:
            with span("step.capture"):
                self._graphs[key] = self._capture(args)
        graph, inputs, outputs = self._graphs[key]
        with span("step.stage"):
            for dst, src in zip(inputs, args):
                if dst is not None and dst is not src:
                    if src.device.type == "cpu" and \
                            dst.device.type == "cuda":
                        src = src.pin_memory()
                    dst.copy_(src, non_blocking=True)
        with span("step.replay"):
            graph.replay()
        self.replays += 1
        with span("step.clone"):
            return _cloned(outputs)

    def _on_side_stream(self, args):
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self.body(*args)
            main.wait_stream(side)
        return out

    def _capture(self, args):
        t0 = time.perf_counter()
        inputs = [None if a is None else torch.empty(
            a.shape, dtype=a.dtype, device=self.device) for a in args]
        for dst, src in zip(inputs, args):
            if dst is not None:
                dst.copy_(src)
        graph, outputs = self._record(inputs)
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        return graph, inputs, outputs

    def _record(self, inputs):
        """(CUDA graph, static outputs) of the body over static inputs."""
        with torch.cuda.device(self.device):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # thread_local: a process group's watchdog thread may query
            # its events while the step is captured
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                outputs = self.body(*inputs)
        return graph, outputs


def optimizer_step(body: Callable, optimizer, device, updates: int = 1,
                   graphs: bool = True,
                   before: Optional[Callable] = None) -> GraphedStep:
    """A GraphedStep whose body makes `updates` updates of `optimizer` (a
    `train.optim.Optimizer`), the i-th at `optimizer.lrs(updates)[i]`: the
    learning rates are written before every call (after `before`, where
    given) and the update count advanced after it."""

    def _before(*args):
        if before is not None:
            before(*args)
        optimizer.next_lrs(updates)

    return GraphedStep(body, device, graphs, before=_before,
                       after=lambda: optimizer.advance(updates))
