#!/usr/bin/env python3
"""Read one torch.profiler trace two ways, then run the tool phases alone.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_profile_read.py

1. One flagship serving pass (`chip_smoke.flagship_codec`, a queue of 4 x
   16 images) is profiled with CPU and CUDA activity, and again with CUDA
   activity only.  Each trace is read by `chip_smoke.kernel_times` (the
   profiler's raw kineto events) and by `kernel_times_tree` below (the
   operator tree of `prof.events()`, which `kernel_times` read before):
   the host seconds of each read, and whether the two give the same kernel
   names, launch counts and device time.
2. `chip_smoke.phase_e2e`, then `chip_smoke.phase_tools` (the fine-tuner,
   the visualizer, the growth-padded serving pass), each timed.

Prints one JSON line per step (the phases print their own), then the
card's name and power limit.  Exits non-zero without CUDA.
"""

import json
import os
import sys
import time

import torch


def kernel_times_tree(prof):
    """chip_smoke.kernel_times computed from `prof.events()`."""
    times, calls = {}, {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.self_device_time_total <= 0):
            continue
        times[e.name] = times.get(e.name, 0.0) + e.self_device_time_total
        calls[e.name] = calls.get(e.name, 0) + 1
    return sorted(((k, times[k], calls[k]) for k in times),
                  key=lambda kv: -kv[1])


def compare_reads(C):
    from torch.profiler import ProfilerActivity, profile

    _, model, codec = C.flagship_codec()
    xs = [torch.from_numpy(x).cuda() for x in C.images(16, 4)]

    def run():
        codec.decompress_many(codec.compress_many(xs), fetch=True)

    run()  # warm-up
    out = {}
    for name, acts in (("cpu_cuda", [ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]),
                       ("cuda", [ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        t0 = time.time()
        raw = {n: (us, c) for n, us, c in C.kernel_times(prof)}
        raw_s = time.time() - t0
        t0 = time.time()
        tree = {n: (us, c) for n, us, c in kernel_times_tree(prof)}
        tree_s = time.time() - t0
        both = set(raw) & set(tree)
        out[name] = {
            "raw_s": raw_s, "tree_s": tree_s, "kernels": len(raw),
            "same_names": set(raw) == set(tree),
            "same_calls": all(raw[n][1] == tree[n][1] for n in both),
            "max_rel_us_diff": max(abs(raw[n][0] - tree[n][0])
                                   / max(tree[n][0], 1e-9) for n in both),
            "busy_raw_ms": sum(v[0] for v in raw.values()) / 1e3,
            "busy_tree_ms": sum(v[0] for v in tree.values()) / 1e3}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_read: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as C

    smi = C.phase_device()
    reads = compare_reads(C)
    C.emit({"step": "profile_reads", **reads})
    assert all(r["same_names"] and r["same_calls"]
               for r in reads.values()), reads
    t0 = time.time()
    e2e = C.phase_e2e()
    C.emit({"step": "e2e", "s": time.time() - t0})
    t0 = time.time()
    C.phase_tools(C.kernel_wrappers(), e2e)
    C.emit({"step": "tools", "s": time.time() - t0})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
