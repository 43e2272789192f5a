"""CUDA graphs: the one capture cache under the codecs and the train
steps, the kernels' launch tallies, and the arithmetic contract.

The JAX package compiles a codec's queue, a train step or a block of K
steps into one program and dispatches it once.  `GraphCache` is the
counterpart: a function of device tensors, keyed by its caller
(`models.exact.FlowCodec` by the queue's layout, `GraphedStep` by its
inputs' shapes and dtypes), run eagerly once, then captured as a CUDA
graph and replayed.
- On the CPU, and in a cache built with `graphs=False`, every call runs
  eagerly.
- On the card a key's first call runs the body eagerly on a side stream
  that waits on the current stream (and the current stream on it after),
  host args staged to the card first: the capture's only warm-up (the
  kernels' libraries, cuDNN plans, cuBLAS handles, an optimizer's lazy
  state), and for a train step a real update.  The second call fills
  fresh static inputs, captures the body over them into the cache's one
  memory pool and replays the graph to do its work (a capture executes
  nothing).  Later calls fill and replay.  A fill copies a host tensor
  from pinned memory without blocking the host and skips an arg that is
  its static input already (`GraphedStep.static_input`).  A failed
  capture or replay raises; nothing falls back to the eager body.
- A replay's outputs are cloned, so a later replay never overwrites what
  a caller holds.
- A cache keeps at most MAX_GRAPHS graphs and MAX_SEEN keys met once, the
  least recently used dropped first: a key met once is never captured,
  and a dropped one runs eagerly again.
- The body reads nothing back to the host and updates state in place.  A
  graph reads its tensors, the parameters too, by address, so it follows
  in-place updates (optimizer steps, `load_state_dict`); code that
  rebinds a parameter tensor needs a new cache.
Counters: `captures`, `capture_seconds`, `replays` (the capturing call's
included), `eager_calls`, `evictions`.  Program spans
(`utils.profiling.span`) under the caller's prefix, none inside the body,
a counted event being the span of its name: `.eager`, `.capture`,
`.evict`, `.stage` (a fill, pinning included, or a first call's upload),
`.replay` (the `replay()` call) and `.clone`.

Launch tallies.  A kernel wrapper counts each launch with `count_launch`:
on its counter or, while `record_launches` is open (a capture), into the
capture's tally, which `CountedGraph.replay` adds to the counters on
every replay, since a replay runs no Python.

A cache on the card pins the process to deterministic float32 arithmetic
(`set_deterministic_cuda`), so that an eager call and its graph, and a
codec's two ends, pick the same kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import torch

from .profiling import span


def set_deterministic_cuda() -> None:
    """Deterministic cuDNN algorithms, no autotuning, no TF32."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# per thread, the tallies of the captures in progress (innermost last)
_captures = threading.local()


def count_launch(wrapper, counter: str = "launches") -> None:
    """Count one launch of `wrapper`'s kernel on its attribute `counter`:
    into the innermost `record_launches` tally while one is open (keyed by
    the wrapper, or by (wrapper, counter) for a counter other than
    `launches`), else on the attribute."""
    key = wrapper if counter == "launches" else (wrapper, counter)
    stack = getattr(_captures, "stack", None)
    if stack:
        stack[-1][key] = stack[-1].get(key, 0) + 1
    else:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


@contextlib.contextmanager
def record_launches():
    """Within this block, launches are tallied into the yielded dict
    ({wrapper: launches}) and not added to the wrappers' counters: the
    kernels are being captured into a CUDA graph."""
    stack = getattr(_captures, "stack", None)
    if stack is None:
        stack = _captures.stack = []
    tally = {}
    stack.append(tally)
    try:
        yield tally
    finally:
        stack.pop()


class CountedGraph:
    """A captured graph (anything with `replay()`, a torch.cuda.CUDAGraph
    on the card) with the kernel launches it holds, as `record_launches`
    tallied them during its capture: each replay adds them to the
    wrappers' counters."""

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = dict(launches)

    def replay(self) -> None:
        self.graph.replay()
        for key, n in self.launches.items():
            wrapper, counter = (key if isinstance(key, tuple)
                                else (key, "launches"))
            setattr(wrapper, counter, getattr(wrapper, counter) + n)


def pool_bytes(pool) -> int:
    """Bytes of the allocator segments of a graph memory pool."""
    if pool is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def _mapped(fn, args):
    """args (tensors, None, and lists and tuples of them) with fn applied
    to each tensor."""
    if isinstance(args, torch.Tensor):
        return fn(args)
    if isinstance(args, (list, tuple)):
        return type(args)(_mapped(fn, a) for a in args)
    return args


def _tensors(args):
    """The tensors of args, in order."""
    out = []
    _mapped(out.append, args)
    return out


def _cloned(out):
    """A copy of a body's outputs (tensors, dataclasses such as
    EncodedStreams, dicts, lists and tuples of them) that no later replay
    writes to."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        return dataclasses.replace(out, **{
            f.name: _cloned(getattr(out, f.name))
            for f in dataclasses.fields(out)})
    if isinstance(out, dict):
        return {k: _cloned(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_cloned(v) for v in out)
    return out


class GraphCache:
    """cache(key, body, args) = body(*args): eager, captured or replayed
    by the rule of the module docstring.  args are tensors, None, and
    lists and tuples of them; a key's body is captured once, so every
    call of a key must pass the same body over args of the same layout."""

    MAX_GRAPHS = 8  # graphs kept
    MAX_SEEN = 64  # keys remembered as met once

    def __init__(self, device, prefix: str, graphs: bool = True):
        self.device = torch.device(device)
        self.prefix = prefix  # of the spans: "codec", "step"
        self.graphs = graphs and self.device.type == "cuda"
        if self.device.type == "cuda":
            set_deterministic_cuda()
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.eager_calls = 0
        self.evictions = 0
        self.pool = None  # the graphs' memory pool, at the first capture
        self.seen = OrderedDict()  # keys met once, least recent first
        # key -> (CountedGraph, static inputs, static outputs)
        self.entries = OrderedDict()

    def _span(self, name: str):
        return span(f"{self.prefix}.{name}")

    def eager(self, run: Callable):
        """run(), a body run eagerly on the current stream: counted in
        `eager_calls`."""
        with self._span("eager"):
            self.eager_calls += 1
            return run()

    def __call__(self, key, body: Callable, args):
        if not self.graphs:
            return self.eager(lambda: body(*args))
        entry = self.entries.get(key)
        if entry is None and key not in self.seen:
            self.seen[key] = None
            while len(self.seen) > self.MAX_SEEN:
                self.seen.popitem(last=False)
            return self.eager(lambda: self._on_side_stream(body, args))
        if entry is None:
            del self.seen[key]
            inputs = _mapped(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=self.device), args)
            self._fill(inputs, args)
            entry = self.entries[key] = self._capture(body, inputs)
            while len(self.entries) > self.MAX_GRAPHS:
                with self._span("evict"):
                    self.evictions += 1
                    self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(key)
            self._fill(entry[1], args)
        graph, _, outputs = entry
        with self._span("replay"):
            graph.replay()
        self.replays += 1
        with self._span("clone"):
            return _cloned(outputs)

    def _fill(self, inputs, args) -> None:
        """Copy args into the static inputs (a host tensor from pinned
        memory, without blocking the host)."""
        with self._span("stage"):
            for dst, src in zip(_tensors(inputs), _tensors(args)):
                if dst is not src:
                    if src.device.type == "cpu" and \
                            dst.device.type == "cuda":
                        src = src.pin_memory()
                    dst.copy_(src, non_blocking=True)

    def _on_side_stream(self, body, args):
        """body(*args) on a side stream, host args staged to the card
        first."""
        if self.device.type != "cuda":
            return body(*args)
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                if any(t.device.type == "cpu" for t in _tensors(args)):
                    with self._span("stage"):
                        args = _mapped(lambda t: t if t.is_cuda else
                                       t.pin_memory().to(
                                           self.device, non_blocking=True),
                                       args)
                out = body(*args)
            main.wait_stream(side)
        return out

    def _capture(self, body, inputs):
        """(CountedGraph, static inputs, static outputs) of body over the
        static inputs."""
        with self._span("capture"):
            t0 = time.perf_counter()
            with record_launches() as tally:
                graph, outputs = self._record(lambda: body(*inputs))
            self.capture_seconds += time.perf_counter() - t0
            self.captures += 1
        return CountedGraph(graph, tally), inputs, outputs

    def _record(self, run):
        """(graph, outputs) of run() captured on the cache's device into
        its pool: the one seam that the CPU tests replace with a stub."""
        with torch.cuda.device(self.device):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # thread_local: a process group's watchdog thread may query
            # its events while the graph is captured
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                outputs = run()
        return graph, outputs


def _signature(args):
    return tuple(None if a is None else (tuple(a.shape), a.dtype)
                 for a in args)


class GraphedStep:
    """step(*args) = before(*args); body(*args) through a GraphCache keyed
    by the args' shapes and dtypes; after().  args are tensors or None.

    `before` (the block's learning rates into a static tensor, a patch
    draw into a static index tensor) and `after` (the optimizer's update
    count) run at every call, graph or not; `eager` is the whole step
    without a graph, on the current stream (what a captured step is held
    against).  Spans: `step.call` (a call, `eager` included),
    `step.before`, `step.after` and the cache's under `step`."""

    def __init__(self, body: Callable, device, graphs: bool = True,
                 before: Optional[Callable] = None,
                 after: Optional[Callable] = None):
        self.body = body
        self.cache = GraphCache(device, "step", graphs)
        self.before, self.after = before, after

    graphs = property(lambda self: self.cache.graphs)
    captures = property(lambda self: self.cache.captures)
    capture_seconds = property(lambda self: self.cache.capture_seconds)
    replays = property(lambda self: self.cache.replays)
    eager_calls = property(lambda self: self.cache.eager_calls)
    evictions = property(lambda self: self.cache.evictions)
    pool_bytes = property(lambda self: pool_bytes(self.cache.pool))

    def eager(self, *args):
        """The step without a graph, on the current stream."""
        return self._run(lambda: self.cache.eager(lambda: self.body(*args)),
                         args)

    def __call__(self, *args):
        return self._run(lambda: self.cache(_signature(args), self.body,
                                            args), args)

    def static_input(self, i: int, like: torch.Tensor) -> torch.Tensor:
        """The static tensor of input i of the graph captured for inputs
        like `like` (shape and dtype), where one exists; else a new device
        tensor.  A caller that stages its input there saves the replay's
        copy."""
        for key, (_, inputs, _) in self.cache.entries.items():
            if key[i] == (tuple(like.shape), like.dtype):
                return inputs[i]
        return torch.empty(like.shape, dtype=like.dtype,
                           device=self.cache.device)

    def _run(self, fn, args):
        with span("step.call"):
            if self.before is not None:
                with span("step.before"):
                    self.before(*args)
            out = fn()
            if self.after is not None:
                with span("step.after"):
                    self.after()
            return out


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
