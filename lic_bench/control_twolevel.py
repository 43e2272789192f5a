"""The comparison's control for the two-level pyramid cells, at the cell's
own size, for setting the limits in `lic_bench/limits/<workload>.json`:

    python3 lic_bench/control_twolevel.py --workload config_twolevel.bulk \\
        --seeds <n> [<n> ...]

prints one JSON line per seed, with `correct` as the cell's limits judge
the reading (the control has to read false).  The control is the plain
reference put in the program's place in TF32 (`precision="tf32"`), the
nearest precision below the float32, TF32 off, that the configuration
states: its split (float32, exact either way) and both sub-flows' latents
and priors on one queue of the seed's batches, held against the float32
reference by the numbers a run compares (`drivers.twolevel_bulk.
twolevel_numbers`), with no containers.  The benchmark's own runs never
run this.
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
from lic_bench.drivers.twolevel_bulk import (reference,  # noqa: E402
                                             twolevel_numbers, weights)
from lic_bench.reference.flow import pin_float32  # noqa: E402
from lic_bench.run import load_json  # noqa: E402


def control_readings(cell):
    t, m = cell.traffic, cell.config["model"]
    w = weights(cell)
    queue = harness.batches(cell.seed, 0, t["queue"], t["batch"],
                            (m["H"], m["W"], m.get("C", 3)))
    xs = [torch.as_tensor(x, device=cell.device) for x in queue]
    ctl = reference(cell, w, "tf32")
    splits, levels = [], []
    with torch.no_grad():
        for x in xs:
            rx, px = ctl.split(x)
            splits.append((rx, px))
            levels.append((ctl.rough.forward(rx), ctl.fine.forward(px)))
    yield "control_tf32", twolevel_numbers(reference(cell, w), xs, splits,
                                           levels)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
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
        for name, nums in control_readings(cell):
            judged = harness.Outcome(setup_s=0.0)
            judged.check(nums, {k: v for k, v in limits.items()
                                if k in nums})
            print(json.dumps({"workload": w["name"], "seed": seed,
                              "reading": name, "correct": judged.correct,
                              **nums}), flush=True)
        harness.free(cell.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
