"""Run one cell of the benchmark once and print its result line.

    python3 lic_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads` entry) names a configuration
(`lic_bench/configs/<config>.json`) and a traffic mix
(`lic_bench/traffic/<traffic>.json`), whose `kind` names the driver
(`lic_bench/drivers/<kind>.py`); the numbers compared for `correct` have
their limits in `lic_bench/limits/<workload>.json`, and each per-layer
metric is read by `lic_bench/metrics/<metric>.py`.  A new cell or metric
is new files and new entries, no edit.

The run builds the program under test (the package
`finalproject_losslessimagecompression_tpu_torch`) with weights and inputs
made from the seed, warms up the cell's own shapes, measures for
`--seconds`, checks what the timed path produced against the plain
reference, and prints, as its last lines on standard error, each number
compared beside its limit, and as the last line of standard output one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` `breakdown`, and last `checks`.  It exits with another
code than 0, and prints no result, where there is no CUDA device or fewer
than the cell asks for, or where the JAX stack or the JAX package was
imported into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "lic_bench")
# run as a script, the folder itself heads the path: import from the root
sys.path[:] = [ROOT] + [q for q in sys.path
                        if os.path.abspath(q or ".") not in (BENCH_DIR, ROOT)]
FORBIDDEN = ("jax", "jaxlib", "flax",
             "finalproject_losslessimagecompression_tpu")


def forbidden_modules(names) -> list:
    """Loaded modules of the JAX stack or the JAX package, compared by the
    whole top-level name (the port's name begins with the JAX package's)."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def metric_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "lic_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def result_line(bench: dict, workload: str, trace: bool, out, kind: str,
                chips: int) -> dict:
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        if trace:
            value = metric_reader(m["name"]).read(out.reading)
        elif m["name"] == "setup_s":
            value = out.setup_s
        else:
            value = out.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace:
        tr = out.reading.trace
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    w = cells[args.workload]
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 3
    from lic_bench import harness

    traffic = load_json(BENCH_DIR, "traffic", w["traffic"] + ".json")
    cell = harness.Cell(
        name=w["name"],
        config=load_json(BENCH_DIR, "configs", w["config"] + ".json"),
        traffic=traffic,
        limits=load_json(BENCH_DIR, "limits", w["name"] + ".json"),
        chips=w["chips"], seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda", 0),
        t_start=T_START)
    driver = importlib.import_module(f"lic_bench.drivers.{traffic['kind']}")
    out = driver.run(cell)
    bad = forbidden_modules(sys.modules)
    if bad:
        print("the run imported " + ", ".join(bad), file=sys.stderr)
        return 4
    line = result_line(bench, w["name"], cell.trace, out,
                       torch.cuda.get_device_name(0), w["chips"])
    for k, v in out.notes.items():
        print(f"note {k} = {v!r}", file=sys.stderr)
    for k, (v, lim) in out.checks.items():
        print(f"check {k} = {v!r} (limit {lim!r}): "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
