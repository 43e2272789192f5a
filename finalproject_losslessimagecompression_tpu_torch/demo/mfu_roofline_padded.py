"""MFU of the parity function through growth-padded architectures.  The
counterpart of the repository's `demo/run_mfu_roofline_r05.py`.

The bench's flagship (float32, seeded weights with perturbed projections)
is trained as `bench.bench_train_mfu` times it, then its weights,
zero-padded by `models.pad_growth_params` into the `growth_multiple=m`
architecture (the same function: padded channels carry exact zeros), are
timed the same way at each multiple.  The padded step runs more raw
FLOPs, so the measure is the parity function's goodput:
`effective_parity_mfu_pct` = parity FLOPs / padded step time / peak, with
`raw_over_parity_flops` beside it.  `verdict` is read off the rows.

Function preservation (`function_check`, at the largest multiple): a
4-image batch (seed 11) through the unpadded and the padded model.  The
padded model's wider reductions can round differently on the card, so
the latents that differ are counted (`latents_differing`) beside
`latents_bit_equal`, not asserted equal; the padded codec must round-trip
bit-exactly.

    python -m finalproject_losslessimagecompression_tpu_torch.demo.mfu_roofline_padded \\
        [--batch 16] [--multiples 16,64,128] [--steps 10] [--windows 3] \\
        [--quick] [--device cpu] [--out results/torch_h100/mfu_roofline_padded.json]
"""

from __future__ import annotations

import argparse
import gc

import numpy as np
import torch

from .. import bench
from ..models.config import with_growth_multiple
from ..models.exact import FlowCodec
from ..models.idflow import IDFlow, resolve_device
from ..models.layers import pad_growth_params
from ..utils.profiling import device_label
from . import write_new


def padded_model(cfg, state_dict, multiple: int, device):
    """(cfg, IDFlow) of the growth_multiple architecture holding the
    zero-padded weights."""
    pcfg = with_growth_multiple(cfg, multiple)
    model = IDFlow(pcfg, device=device)
    model.load_state_dict(pad_growth_params(state_dict, multiple))
    return pcfg, model.eval()


def function_check(cfg, model, multiple: int, batch: int = 4,
                   seed: int = 11) -> dict:
    """The unpadded and the padded model on a `batch`-image batch: latents
    that differ (and whether none does), the priors' largest mean
    difference, and the padded codec's round trip (raises unless
    bit-exact)."""
    device = model.device
    x = bench.batches(batch, 1, seed=seed, device=device)[0]
    _, pmodel = padded_model(cfg, model.state_dict(), multiple, device)
    with torch.no_grad():
        la, lb = model(x), pmodel(x)
    differ = sum(int((a != b).sum()) for a, b in zip(la[0], lb[0]))
    codec = FlowCodec(pmodel, num_streams=bench.CODEC_STREAMS)
    blobs, info = codec.compress(x)
    rec = codec.decompress(blobs, info, fetch=True)
    if not np.array_equal(rec, x.cpu().numpy()):
        raise AssertionError(f"growth_multiple {multiple}: the padded "
                             "codec's round trip is not bit-exact")
    return {"checked_multiple": multiple,
            "latents_bit_equal": differ == 0,
            "latents_differing": differ,
            "latents_total": sum(t.numel() for t in la[0]),
            "max_mean_abs_dev": max(float((a - b).abs().max())
                                    for a, b in zip(la[1], lb[1])),
            "padded_codec_bit_exact": True,
            "kernel_shapes": bench.coded_shapes(codec, [batch])}


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(batch: int = 16, multiples=(16, 64, 128), steps: int = 10,
        windows: int = 3, quick: bool = False, device=None) -> dict:
    device = resolve_device(device)
    cfg, model = bench.build_model(quick, bf16=False, device=device)
    # the parity weights before training moves them
    host = {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}
    preserve = function_check(cfg, model, max(multiples))
    _free(device)

    parity = bench.bench_train_mfu(cfg, model, batch, steps, windows)
    del model
    _free(device)
    parity_flops = parity["train_flops_per_step"]
    peak = parity["mfu_peak_tflops"]
    rows = [{"variant": "parity", "growth_multiple": 0,
             "effective_parity_mfu_pct": parity["train_mfu_pct"],
             **parity}]
    for m in multiples:
        pcfg, pmodel = padded_model(cfg, host, m, device)
        out = bench.bench_train_mfu(pcfg, pmodel, batch, steps, windows)
        del pmodel
        _free(device)
        eff = parity_flops / (out["train_step_time_device_ms"] / 1e3) / 1e12
        rows.append({
            "variant": f"parity_padded_gm{m}", "growth_multiple": m,
            "effective_parity_tflops": eff,
            "effective_parity_mfu_pct": 100.0 * eff / peak if peak else None,
            "raw_over_parity_flops": out["train_flops_per_step"]
            / parity_flops,
            **out})
        print({k: rows[-1][k] for k in ("variant",
                                        "train_step_time_device_ms",
                                        "effective_parity_mfu_pct")},
              flush=True)
    speed = lambda r: r["train_step_time_device_ms"]  # noqa: E731
    best = min(rows, key=speed)
    return {
        "what": "MFU of the parity function through growth-padded "
                "architectures: the flagship's weights zero-padded into "
                "growth_multiple=m (same function); effective_parity_mfu_pct "
                "= parity FLOPs / padded step time / peak",
        "device": device_label(device),
        "batch": batch, "steps_per_window": steps, "windows": windows,
        "quick": quick,
        "function_preservation": preserve,
        "parity_flops_per_step": parity_flops,
        "rows": rows,
        "best_variant": best["variant"],
        "best_effective_parity_mfu_pct": best["effective_parity_mfu_pct"],
        "verdict": (
            "CONFIRMED: a padded architecture runs the parity function "
            "faster" if best["variant"] != "parity" else
            "REFUTED: every padded variant's extra FLOPs outweigh its gain; "
            "the parity function is fastest in its own shape"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--multiples", default="16,64,128")
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
    out = run(args.batch, [int(m) for m in args.multiples.split(",") if m],
              args.steps, args.windows, args.quick, args.device)
    print(out["verdict"], out["function_preservation"])
    if args.out:
        write_new(args.out, out)
    return out


if __name__ == "__main__":
    main()
