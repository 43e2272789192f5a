#!/usr/bin/env python3
"""The DenseLayer kernel's two geometries on one NVIDIA GPU: the split
counts of the narrow one, and the wide one against another build.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_dense_compare.py [--against OTHER.cu] [--out FILE]

1. `splits`: at every launch shape of the two-level model's fine sub-flow
   (4x4 tiles at batch 4, recorded by `chip_smoke.twolevel_launch_shapes`),
   the kernel's device ms (`chip_smoke.graph_ms`) at each split count of K
   from 1 to 12, beside the count `ops.dense_conv.geometry` picks: what
   `narrow_splits` rests on.  Each count's output is held to the plain
   version at `chip_smoke.DENSE_TOL`.
2. `against` (with --against): OTHER.cu is a source of the same kernel with
   the interface that takes no geometry, `dense_conv3x3_launch(buf, w,
   bias_a, b3, part, M, H, W, P, cin, g, splits, slope, stream)` and its
   reduce without the tile width (the wide geometry alone).  At every launch
   shape of imagenet64's and resflow-cond-imagenet64's inference passes and
   of the two-level rough sub-flow, both libraries run on the same inputs:
   whether their outputs are equal bit for bit, and each one's device ms,
   timed in turns (package, other, other, package).

Prints one JSON line per shape and a summary line, writes every row to
FILE (default logs/dense_compare.json), then the card's name and
power limit.  Exits non-zero without CUDA or when a check fails.
"""

import argparse
import ctypes
import json
import math
import os
import sys

import torch

import chip_smoke as C
from finalproject_losslessimagecompression_tpu_torch.codec.native import (
    build_native,
    find_nvcc,
    stream,
)
from finalproject_losslessimagecompression_tpu_torch.utils.graphs import (
    set_deterministic_cuda,
)
from finalproject_losslessimagecompression_tpu_torch.ops import dense_conv as D


def operands(shape, cin, g, seed):
    """A seeded buffer (NaN from cin on) and the layer's operands."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(shape, generator=gen, device="cuda")
    buf[..., cin:] = float("nan")
    wk = torch.randn((9, cin, g), generator=gen, device="cuda") / math.sqrt(
        9 * cin)
    bias_a = 0.1 * torch.randn((g, 9), generator=gen, device="cuda")
    b3 = 0.1 * torch.randn((g,), generator=gen, device="cuda")
    return buf, wk, bias_a, b3


def launch(lib, buf, cin, wk, bias_a, b3, slope, row_w, tile_n, splits):
    """The package's kernel at a given geometry and split count."""
    n, h, w, p = buf.shape
    m, g = n * h * w, wk.shape[-1]
    part = buf.new_empty((splits, m, -(-g // tile_n) * tile_n)
                         if splits > 1 else (0,))
    ptrs = (buf.data_ptr(), wk.data_ptr(), bias_a.data_ptr(), b3.data_ptr())
    assert lib.dense_conv3x3_launch(
        *ptrs, part.data_ptr(), m, h, w, p, cin, g, row_w, tile_n, splits,
        slope, stream()) == 0
    if splits > 1:
        assert lib.dense_conv3x3_reduce_launch(
            buf.data_ptr(), part.data_ptr(), *ptrs[2:], m, h, w, p, cin, g,
            tile_n, splits, slope, stream()) == 0


def other_library(src):
    """OTHER.cu built and bound with the interface that takes no geometry."""
    lib = ctypes.CDLL(build_native(src, find_nvcc(), D.NVCC_FLAGS,
                                   "dense_conv_other"))
    p, i, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dense_conv3x3_launch.restype = i
    lib.dense_conv3x3_launch.argtypes = [p] * 5 + [i] * 7 + [f32, p]
    lib.dense_conv3x3_reduce_launch.restype = i
    lib.dense_conv3x3_reduce_launch.argtypes = [p] * 4 + [i] * 7 + [f32, p]
    return lib


def launch_other(lib, buf, cin, wk, bias_a, b3, slope, splits):
    n, h, w, p = buf.shape
    m, g = n * h * w, wk.shape[-1]
    part = buf.new_empty((splits, m, -(-g // D.TILE_N) * D.TILE_N)
                         if splits > 1 else (0,))
    ptrs = (buf.data_ptr(), wk.data_ptr(), bias_a.data_ptr(), b3.data_ptr())
    assert lib.dense_conv3x3_launch(
        *ptrs, part.data_ptr(), m, h, w, p, cin, g, splits, slope,
        stream()) == 0
    if splits > 1:
        assert lib.dense_conv3x3_reduce_launch(
            buf.data_ptr(), part.data_ptr(), *ptrs[2:], m, h, w, p, cin, g,
            splits, slope, stream()) == 0


def splits_rows(lib, fine, max_splits=12):
    rows = []
    for i, (shape, cin, g, slope) in enumerate(dict.fromkeys(fine)):
        geo = C.dense_geometry(shape, cin, g)
        buf, wk, bias_a, b3 = operands(shape, cin, g, 700 + i)
        ref = buf.clone()
        D.dense_conv3x3_plain(ref, cin, wk, bias_a, b3, slope)
        want = ref[..., cin:cin + g]
        scale = max(float(want.abs().max()), 1.0)
        stages = -(-cin // D.STAGE_CH) * 3
        times, errs = {}, {}
        for s in range(1, min(max_splits, stages) + 1):
            out = buf.clone()
            launch(lib, out, cin, wk, bias_a, b3, slope, geo.row_w,
                   geo.tile_n, s)
            torch.cuda.synchronize()
            errs[s] = float((out[..., cin:cin + g] - want).abs().max())
            times[s] = C.graph_ms(lambda: launch(
                lib, out, cin, wk, bias_a, b3, slope, geo.row_w, geo.tile_n,
                s))
        row = {"shape": list(shape), "cin": cin, "g": g, "row_w": geo.row_w,
               "tile_n": geo.tile_n, "picked": geo.splits,
               "calls": fine.count((shape, cin, g, slope)), "ms": times,
               "best": min(times, key=times.get), "scale": scale,
               "max_err": errs,
               "ok": max(errs.values()) <= C.DENSE_TOL * scale}
        rows.append(row)
        C.emit({"phase": "dense_splits", **row})
    return rows


def against_rows(lib, other, shapes):
    rows = []
    for i, (config, (shape, cin, g, slope)) in enumerate(shapes):
        geo = C.dense_geometry(shape, cin, g)
        assert geo.row_w == 0, (shape, geo)
        buf, wk, bias_a, b3 = operands(shape, cin, g, 800 + i)
        mine, theirs = buf.clone(), buf.clone()
        D.dense_conv3x3(mine, cin, wk, bias_a, b3, slope)
        launch_other(other, theirs, cin, wk, bias_a, b3, slope, geo.splits)
        torch.cuda.synchronize()
        same = torch.equal(mine.view(torch.int32), theirs.view(torch.int32))

        def run_mine():
            D.dense_conv3x3(mine, cin, wk, bias_a, b3, slope)

        def run_theirs():
            launch_other(other, theirs, cin, wk, bias_a, b3, slope,
                         geo.splits)

        ms = [C.graph_ms(f) for f in (run_mine, run_theirs, run_theirs,
                                      run_mine)]
        row = {"config": config, "shape": list(shape), "cin": cin, "g": g,
               "splits": geo.splits, "bits_equal": same,
               "kernel_ms": (ms[0] + ms[3]) / 2,
               "other_ms": (ms[1] + ms[2]) / 2, "ms_in_turn": ms}
        rows.append(row)
        C.emit({"phase": "dense_against", **row})
    return rows


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against")
    ap.add_argument("--out", default=os.path.join(C.ROOT, "logs",
                                                  "dense_compare.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_dense_compare: no CUDA device", file=sys.stderr)
        return 1
    set_deterministic_cuda()  # the plain version's cuDNN conv without TF32
    lib = D._load()
    _, tl = C.twolevel_flow()
    rough, fine = C.twolevel_launch_shapes(
        tl, torch.from_numpy(C.twolevel_images(4, 16)).cuda())
    del tl
    out = {"splits": splits_rows(lib, fine)}
    ok = all(r["ok"] for r in out["splits"])
    if args.against:
        _, model, _ = C.flagship_codec()
        x = torch.from_numpy(C.images(16, 1, seed=7)[0]).cuda()
        bulk = C.dense_launch_shapes(model, x)
        del model
        flow = C.cond_flow()
        req = C.dense_launch_shapes(flow, x[:4], torch.flip(x[:4], dims=(1,)))
        del flow
        shapes = [(name, key) for name, keys in (
            ("imagenet64", bulk), ("resflow-cond", req), ("rough", rough))
            for key in dict.fromkeys(keys)]
        out["against"] = against_rows(lib, other_library(args.against),
                                      shapes)
        ok &= all(r["bits_equal"] for r in out["against"])
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    summary = {"phase": "dense_compare", "ok": ok, "out": args.out,
               "picked_is_best": sum(r["picked"] == r["best"]
                                     for r in out["splits"]),
               "fine_shapes": len(out["splits"]),
               "fine_ms_batch_picked": sum(
                   r["ms"][r["picked"]] * r["calls"] for r in out["splits"]),
               "fine_ms_batch_best": sum(
                   r["ms"][r["best"]] * r["calls"] for r in out["splits"])}
    if "against" in out:
        summary.update(
            wide_shapes=len(out["against"]),
            wide_bits_equal=all(r["bits_equal"] for r in out["against"]),
            wide_ms_ratio_max=max(r["kernel_ms"] / r["other_ms"]
                                  for r in out["against"]))
    C.emit(summary)
    print(C.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
