"""Readings of the comparison's control and of planted faults, at a cell's
own size, for setting the limits in `lic_bench/limits/<workload>.json`:

    python3 lic_bench/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line per seed and reading, with `correct` as the cell's
limits judge the reading (a control and a fault have to read false).
`--calls` sets a train cell's late state (see `train_readings`).  The
control is the plain
reference put in the program's place in TF32 (`precision="tf32"`), the
nearest precision below the float32, TF32 off, that the configuration
states; it is held against the float32 reference by the same numbers a
run compares.  A train cell also reads the fault of a step that leaves
out half of the batch (the mean taken over the rest), with the plain
step in the program's place; a state left unchanged reads 1 by the
leaf measure and needs no run.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [q for q in sys.path if os.path.abspath(q or ".")
                        not in (os.path.join(ROOT, "lic_bench"), ROOT)]

import torch  # noqa: E402

from lic_bench import harness  # noqa: E402
from lic_bench.drivers.train import global_rows  # noqa: E402
from lic_bench.judge import (codec_numbers, residual_numbers,  # noqa: E402
                             train_numbers)
from lic_bench.reference.flow import Flow, pin_float32  # noqa: E402
from lic_bench.reference.train import PlainTrainer  # noqa: E402
from lic_bench.reference.vqvae import VQVAE  # noqa: E402
from lic_bench.run import load_json  # noqa: E402


class HalfBatch(PlainTrainer):
    """The plain step with half of each batch left out."""

    def step(self, batch, chunks: int = 1):
        return super().step(batch[: batch.shape[0] // 2], chunks)


def codec_readings(cell):
    t, a = cell.traffic, cell.arch()
    w = cell.weights()
    queue = harness.batches(cell.seed, 0, t["queue"], t["batch"],
                            (a.H, a.W, a.C))
    xs = [torch.as_tensor(x, device=cell.device) for x in queue]
    ref, ctl = Flow(a, w), Flow(a, w, precision="tf32")
    with torch.no_grad():
        levels = [ctl.forward(x) for x in xs]
    yield "control_tf32", codec_numbers(ref, xs, levels)


def request_readings(cell):
    t, c, a = cell.traffic, cell.config, cell.arch()
    size = tuple(c["input_size"]) + (a.C,)
    xs = [torch.as_tensor(x, device=cell.device) for x in harness.batches(
        cell.seed, 0, t["pool"], t["batch"], size)]
    fw, vw = cell.weights(), cell.vq_weights()
    ctl_vq, ctl = VQVAE(c["vqvae"], vw, "tf32"), Flow(a, fw, "tf32")
    idxs = [ctl_vq.indices(x) for x in xs]
    recs = [ctl_vq.reconstruction(i, a.nbits) for i in idxs]
    with torch.no_grad():
        sampled = [(x, r, ctl.forward(x - r, r), None) for x, r in
                   list(zip(xs, recs))[:t["sample_requests"]]]
    yield "control_tf32", residual_numbers(VQVAE(c["vqvae"], vw), Flow(a, fw),
                                           xs, idxs, recs, sampled)


def train_readings(cell, calls: int = 2):
    """The plain step in the program's place on the cell's global batches
    (a four-card cell's 64 rows, its gradient over four chunks): over the
    first two calls from the seeded weights, and over one late call from
    the float32 plain step's state after `calls` calls (the window's rows,
    cycled over the pool), as a run compares the program's."""
    c, a = cell.config, cell.arch()
    K, b = c["steps_per_dispatch"], cell.traffic["batch"] * cell.chips
    args = (c["optimizer"], c["scheduler"], c["step_per_epoch"])

    def side(cls, start, idx, precision="float32"):
        tr = cls(a, start["params"], *args, precision=precision,
                 state=start)
        for i in idx:
            for j in range(K):
                tr.step(torch.as_tensor(
                    global_rows(cell, i % cell.traffic["pool"], j, 0, b),
                    device=cell.device), chunks=cell.chips)
        return tr

    def state(tr):
        return {"params": {k: v.detach() for k, v in tr.params.items()},
                "m": tr.m, "u": tr.u, "count": tr.count}

    init = {"params": cell.weights(), "m": {}, "u": {}, "count": 0}
    ref = side(PlainTrainer, init, range(2))
    start = state(side(PlainTrainer, state(ref), range(2, calls)))
    ref_late = side(PlainTrainer, start, [calls])
    for name, cls, precision in (("control_tf32", PlainTrainer, "tf32"),
                                 ("fault_half_batch", HalfBatch, "float32")):
        early = side(cls, init, range(2), precision)
        nums = train_numbers(ref, init, early.losses, state(early))
        late = side(cls, start, [calls], precision)
        nums.update(train_numbers(ref_late, start, late.losses, state(late),
                                  ".late"))
        yield name, nums
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=2,
                   help="a train cell's plain calls before its late call")
    args = p.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    w = {x["name"]: x for x in bench["workloads"]}[args.workload]
    traffic = load_json(ROOT, "lic_bench", "traffic", w["traffic"] + ".json")
    limits = load_json(ROOT, "lic_bench", "limits", w["name"] + ".json")
    pin_float32()
    for seed in args.seeds:
        cell = harness.Cell(
            w["name"], load_json(ROOT, "lic_bench", "configs",
                                 w["config"] + ".json"),
            traffic, limits, w["chips"], seed, 0.0, False,
            torch.device("cuda" if torch.cuda.is_available() else "cpu"),
            time.perf_counter())
        read = {"train": lambda cell: train_readings(cell, args.calls),
                "bulk": codec_readings,
                "request": request_readings}[traffic["kind"]]
        for name, nums in read(cell):
            judged = harness.Outcome(setup_s=0.0)
            judged.check(nums, limits)
            print(json.dumps({"workload": w["name"], "seed": seed,
                              "reading": name, "correct": judged.correct,
                              **nums}), flush=True)
        harness.free(cell.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
