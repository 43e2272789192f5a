"""Training: `make_multi_train_step` over the published optimizer and
schedule, K = `steps_per_dispatch` steps a call, the K batches of a call
uploaded in one copy as the package's trainer does, one host sync a call
(the call's K losses).  A cell on more than one card runs the same step
data-parallel (`make_multi_train_step(..., mesh=)`, NCCL, one card a
rank): each rank steps `batch` rows of a global batch of `batch` x ranks,
and rank 0 reports.

Set-up builds the model, the optimizer and the step, and makes the first
two calls: the first runs eagerly, the second captures the step's graph
and replays it, each on rows of its own.  The parameters, Adamax's first
moments and the eight losses after them are what the comparison reads;
the window then goes on with the same object.  After the window (and the
traced calls) the step makes one more call, on the rows the pool cycles
to, and the comparison reads its four losses and the parameters and
moments before and after it: the plain step follows it from that state.

Traffic keys: `batch` (rows a rank), `pool` (calls' worth of distinct
batches drawn from the seed, cycled in the window; the first two go to
the two set-up calls), `trace_calls` (calls under the profiler in a
traced run).  The end-to-end metric is `train_images_per_s`: the images
stepped in the window, on every card, over its seconds.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from .. import harness
from ..data import natural_images
from ..judge import train_numbers
from ..reduce import flow_flops
from ..reference.train import PlainTrainer

PKG = "finalproject_losslessimagecompression_tpu_torch"


def snapshot(model, optimizer) -> dict:
    """Host copies of the parameters and of Adamax's moments, by leaf name
    (the optimizer's state is keyed by position in the model's parameter
    order), and the update count: {"params", "m", "u", "count"}."""
    names = [n for n, _ in model.named_parameters()]
    sd = optimizer.state_dict()
    return {"params": {n: p.detach().cpu().clone()
                       for n, p in model.named_parameters()},
            "m": {names[i]: st["exp_avg"].detach().cpu().clone()
                  for i, st in sd["state"].items()},
            "u": {names[i]: st["exp_inf"].detach().cpu().clone()
                  for i, st in sd["state"].items()},
            "count": int(sd["count"])}


def global_rows(cell, call: int, step: int, lo: int, count: int):
    """Rows [lo, lo + count) of the global batch of a call's step."""
    a, K = cell.arch(), cell.config["steps_per_dispatch"]
    G = cell.traffic["batch"] * cell.chips
    return natural_images(cell.seed, (call * K + step) * G + lo, count,
                          (a.H, a.W, a.C))


def run(cell: "harness.Cell"):
    if cell.chips > 1 and not cell.port:
        return harness.run_ranks(cell, run)
    optim = importlib.import_module(PKG + ".train.optim")
    trainer = importlib.import_module(PKG + ".train.trainer")
    t, c, dev = cell.traffic, cell.config, cell.device
    K, b, world = c["steps_per_dispatch"], t["batch"], cell.chips
    a = cell.arch()
    mesh = None
    if world > 1:
        pm = importlib.import_module(PKG + ".parallel.mesh")
        pm.init_distributed(device=dev, rank=cell.rank, world_size=world,
                            init_method=f"tcp://localhost:{cell.port}")
        mesh = pm.make_mesh((world, 1), device=dev)
    model = cell.program_flow(cell.weights())
    optimizer = optim.build_optimizer(model.parameters(), c["optimizer"],
                                      c["scheduler"], c["step_per_epoch"])
    multi = trainer.make_multi_train_step(model, optimizer, K, mesh=mesh)

    def block(i):
        x = torch.from_numpy(np.stack([
            global_rows(cell, i, j, cell.rank * b, b) for j in range(K)]))
        return x.pin_memory() if dev.type == "cuda" else x

    pool = [block(i) for i in range(t["pool"])]

    def call(i):
        return multi(pool[i % len(pool)].to(dev, non_blocking=True)).cpu()

    def go_on(ok: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if mesh is None:
            return ok
        flag = torch.tensor([float(ok)], device=dev)
        mesh.broadcast_(flag, src=0)
        return bool(flag.item())

    first = [float(v) for i in range(2) for v in call(i)]
    early = snapshot(model, optimizer) if cell.rank == 0 else None
    out = harness.Outcome(setup_s=cell.elapsed())
    spans = {"call": []}
    steps = bad = calls = 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        losses = call(2 + calls)
        spans["call"].append(time.perf_counter() - t0)
        steps += K
        bad += int((~torch.isfinite(losses)).sum())
        calls += 1
        if not go_on(time.perf_counter() - t_start < cell.seconds):
            break
    window = time.perf_counter() - t_start
    out.e2e["train_images_per_s"] = steps * b * world / window
    out.attempted, out.failed = steps, bad

    if cell.trace:
        def traced():
            for i in range(t["trace_calls"]):
                call(2 + calls + i)

        if cell.rank == 0:
            out.reading = harness.Reading(
                trace=harness.traced(traced, dev), spans=spans,
                passes=t["trace_calls"], window_s=window, windows=calls,
                flops_per_pass=K * flow_flops(a, b * world, backward=True),
                extra={"ranks": world, "steps": K})
        else:
            traced()
    # one more call of the window's own step, from the state the window
    # left; the reference follows it from that state
    late = 2 + calls + (t["trace_calls"] if cell.trace else 0)
    before = snapshot(model, optimizer) if cell.rank == 0 else None
    late_losses = [float(v) for v in call(late)]
    after = snapshot(model, optimizer) if cell.rank == 0 else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del multi, optimizer, model
    if mesh is not None:
        top = torch.tensor([float(peak)], dtype=torch.float64, device=dev)
        peak = int(mesh.all_reduce(top, op="max").item())
        pm.shutdown()
        if cell.rank != 0:
            return None
    out.memory_peak_bytes = peak
    harness.free(dev)

    def follow(start, calls):
        ref = PlainTrainer(a, {k: v.to(dev) for k, v in
                               start["params"].items()},
                           c["optimizer"], c["scheduler"], c["step_per_epoch"],
                           state=start)
        for i in calls:
            for j in range(K):
                ref.step(torch.as_tensor(global_rows(
                    cell, i % t["pool"], j, 0, b * world), device=dev),
                    chunks=world)
        return ref

    where = {}
    init = {"params": cell.weights(), "m": {}, "u": {}, "count": 0}
    nums = train_numbers(follow(init, range(2)), init, first, early,
                         where=where)
    harness.free(dev)
    nums.update(train_numbers(follow(before, [late]), before, late_losses,
                              after, ".late", where))
    out.check(nums, cell.limits)
    out.notes.update({"worst_leaf." + k: v for k, v in where.items()})
    return out
