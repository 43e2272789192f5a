"""MFU roofline of the flagship train step: the parity step timed twice
(sessions A and B of one process), then the variants of its conv stack.
The counterpart of the repository's `demo/run_mfu_roofline.py`.

Every row is `bench.bench_train_mfu` (a host loop of single-step graph
replays and one K-step graph replay per window, medians over windows,
FLOPs from `FlopCounterMode` beside the analytic count, MFU against the
peak of the step's own arithmetic) on a model of the flagship's shape
(64x64x3, nflows 8, nsplit 3, DenseBlocks 512 x 12 ReLU) with seeded
weights and perturbed projections:

    flagship_parity_session_A/B  float32, the 1x1 and 3x3 convs apart
                                 (`fuse_1x1` false, as the JAX script's
                                 `build` defaults);
    flagship_fused               the 1x1 folded into the 3x3;
    flagship_bf16                bfloat16 conv stacks;
    flagship_fused_bf16          both;
    growth_multiple_128          every layer's growth rounded up to 128
                                 channels (not the parity function).

Each variant's model, graphs and optimizer are freed before the next is
built; each row carries its peak memory.  `session_agreement_pct` compares
the two parity sessions' device step times; `findings` are computed from
these rows alone.

    python -m finalproject_losslessimagecompression_tpu_torch.demo.mfu_roofline \\
        [--batch 16] [--steps 10] [--windows 3] [--device cpu] [--quick] \\
        [--out results/torch_h100/mfu_roofline.json]
"""

from __future__ import annotations

import argparse
import gc
from dataclasses import replace

import torch

from .. import bench
from ..models.config import CouplingCfg, DenseBlockCfg, FlowCfg
from ..models.idflow import IDFlow, resolve_device
from ..utils.profiling import device_label
from . import write_new

VARIANTS = (
    ("flagship_parity_session_A", {}),
    ("flagship_parity_session_B", {}),
    ("flagship_fused", {"fuse": True}),
    ("flagship_bf16", {"bf16": True}),
    ("flagship_fused_bf16", {"fuse": True, "bf16": True}),
    ("growth_multiple_128", {"growth_multiple": 128}),
)


def build(growth_multiple: int = 0, bf16: bool = False, fuse: bool = False,
          seed: int = 0, quick: bool = False, device=None):
    """(cfg, IDFlow) of the flagship (or the bench's quick model) with the
    variant's conv stack, seeded weights, projections perturbed."""
    dt = "bfloat16" if bf16 else "float32"
    if quick:
        base = bench.flow_cfg(True, bf16)
        nn = replace(base.couple.nn, fuse_1x1=fuse,
                     growth_multiple=growth_multiple)
        cfg = replace(base, couple=replace(base.couple, nn=nn), prior_nn=nn)
    else:
        nn = DenseBlockCfg(512, 12, "ReLU", dt, fuse_1x1=fuse,
                           growth_multiple=growth_multiple)
        cfg = FlowCfg(H=64, W=64, C=3, nflows=8, nsplit=3,
                      couple=CouplingCfg(0.75, nn), prior_nn=nn)
    return cfg, bench.perturbed(IDFlow(cfg, device=resolve_device(device),
                                       seed=seed))


def findings(rows) -> list:
    """Statements read off the rows: the fastest variant, and each
    variant's device step time and MFU against the parity session A's."""
    by = {r["variant"]: r for r in rows}
    base = by["flagship_parity_session_A"]
    t0 = base["train_step_time_device_ms"]
    out = []
    fastest = min(rows, key=lambda r: r["train_step_time_device_ms"])
    out.append(f"fastest step: {fastest['variant']} at "
               f"{fastest['train_step_time_device_ms']:.2f} ms")
    for r in rows[2:]:
        t = r["train_step_time_device_ms"]
        mfu = r.get("train_mfu_pct")
        out.append(
            f"{r['variant']}: device step {t:.2f} ms, {t0 / t:.3f}x the "
            f"parity step's speed, FLOPs {r['train_flops_per_step'] / base['train_flops_per_step']:.3f}x"  # noqa: E501
            + (f", MFU {mfu:.2f}% of {r['mfu_peak_tflops']} TFLOP/s"
               if mfu is not None else ""))
    return out


def run(batch: int = 16, steps: int = 10, windows: int = 3,
        quick: bool = False, variants=VARIANTS, device=None) -> dict:
    device = resolve_device(device)
    rows = []
    for name, kw in variants:
        cfg, model = build(quick=quick, device=device, **kw)
        out = bench.bench_train_mfu(cfg, model, batch, steps, windows)
        rows.append({"variant": name,
                     "growth_multiple": kw.get("growth_multiple", 0),
                     "bf16": kw.get("bf16", False),
                     "fuse_1x1": kw.get("fuse", False), **out})
        print({k: rows[-1][k] for k in ("variant",
                                        "train_step_time_device_ms",
                                        "train_mfu_pct", "peak_mem_gb")},
              flush=True)
        del model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    a = rows[0]["train_step_time_device_ms"]
    b = rows[1]["train_step_time_device_ms"]
    return {
        "what": "MFU roofline of the flagship train step: the parity step "
                "in two sessions, the fused, bf16 and growth-padded "
                "variants; MFU against the peak of each step's own "
                "arithmetic",
        "device": device_label(device),
        "batch": batch, "steps_per_window": steps, "windows": windows,
        "quick": quick,
        "session_agreement_pct": 100.0 * abs(a - b) / min(a, b),
        "rows": rows,
        "findings": findings(rows),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="the bench's small model (a CPU run of the "
                    "harness)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                    "the CPU)")
    ap.add_argument("--out", default=None,
                    help="a new JSON file for the result")
    args = ap.parse_args(argv)
    out = run(args.batch, args.steps, args.windows, args.quick,
              device=args.device)
    print(out["findings"])
    if args.out:
        write_new(args.out, out)
    return out


if __name__ == "__main__":
    main()
