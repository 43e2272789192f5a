#!/usr/bin/env python3
"""Where a decode step's time goes: timing-only variants of the rANS decode
kernel on one NVIDIA GPU.

Run from the repository root with no arguments (needs a card and nvcc):

    python3 chip_decode_variants.py

Each variant is the kernel source (csrc/rans_kernels.cu) with one textual
patch that removes or changes one part of a step, built with the package's
nvcc flags into the package's git-ignored build/ directory.  Every variant
decodes the same encoded message, and its device time per launch is taken
with torch.profiler.  Only `base` decodes correctly (checked); the others
are timing probes:

    base       the kernel as committed
    count      base plus a global counter of guesses that missed
    nomiss     a missed guess is not searched further
    skeleton   no search at all: the refill ranking, the barrier, the ring,
               the loads and stores and the state update remain
    noring     skeleton without the ring refills (cp.async) and their wait
    nobarrier  skeleton with the per-step barrier replaced by a warp sync
    ahead1     one stream per thread, parameters prefetched 1 step ahead
    depth1     one stream per thread, ring refills 1 step ahead

Shapes: the flagship levels (S=384, k=256 and S=768, k=64), four S=384
containers in one launch, and the 8M-symbol message (S=8192, k=1024) on two
seeds.  Prints the card and one JSON line per shape.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

SEARCH = [("if (!(ok_b && nok_a)) {", "if (false) {")]
SKELETON = SEARCH + [
    ("g[q] = guess_bin(mod[q], pm[u][i], ps[u][i], pl[u][i]);",
     "g[q] = pl[u][i] + (int)(mod[q] & 2047);"),
    ("ca[q] = cdf_bits(g[q] - 1, pm[u][i], ps[u][i], pl[u][i]);",
     "ca[q] = (uint32_t)g[q] * 977u;"),
    ("cb[q] = cdf_bits(g[q], pm[u][i], ps[u][i], pl[u][i]);",
     "cb[q] = (uint32_t)g[q] * 979u;"),
]
VARIANTS = {
    "base": [],
    "count": [
        ("namespace {", "__device__ unsigned long long g_miss;\nnamespace {"),
        ("          if (!(ok_b && nok_a)) {\n",
         "          if (!(ok_b && nok_a)) atomicAdd(&g_miss, 1ull);\n"
         "          if (!(ok_b && nok_a)) {\n"),
        ('extern "C" {',
         'extern "C" {\nunsigned long long read_misses() {\n'
         '  unsigned long long h = 0, z = 0;\n'
         '  cudaMemcpyFromSymbol(&h, g_miss, 8);\n'
         '  cudaMemcpyToSymbol(g_miss, &z, 8);\n  return h;\n}'),
    ],
    "nomiss": SEARCH,
    "skeleton": SKELETON,
    "noring": SKELETON + [
        ("        cp_async4(&ring[idx & ring_mask], in ? (const void*)(buf + idx) "
         ": buf,\n                  in);", ""),
        ("      cp_async_wait<DEPTH>();\n", ""),
    ],
    "nobarrier": SKELETON + [("      __syncthreads();\n      int total",
                              "      __syncwarp();\n      int total")],
    "ahead1": [("case 1: LAUNCH(1, 8, 2);", "case 1: LAUNCH(1, 1, 2);")],
    "depth1": [("case 1: LAUNCH(1, 8, 2);", "case 1: LAUNCH(1, 8, 1);")],
}
SHAPES = [(384, 256, 1, 5), (768, 64, 1, 5), (384, 256, 4, 5),
          (8192, 1024, 1, 5), (8192, 1024, 1, 7)]


def build_all(cuda_rans, build_dir):
    """Patch and build every variant in parallel; returns name -> CDLL."""
    from finalproject_losslessimagecompression_tpu_torch.codec.native import (
        find_nvcc,
    )

    src = open(cuda_rans._SRC).read()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch target not found")
            text = text.replace(old, new)
        path = os.path.join(build_dir, f"variant_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [find_nvcc(), *cuda_rans.NVCC_FLAGS, "-diag-suppress",
             "177", "-o", path[:-3] + ".so", path])
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"variant {name} failed to build")
        lib = ctypes.CDLL(os.path.join(build_dir, f"variant_{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rans_decode_launch.restype = i
        lib.rans_decode_launch.argtypes = (
            [p, ctypes.c_int64] + [p] * 9 + [i] * 5 + [p])
        libs[name] = lib
    libs["count"].read_misses.restype = ctypes.c_ulonglong
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_decode_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        cuda_rans,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        interleaved as IL,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.native import (
        BUILD_DIR,
    )

    os.makedirs(BUILD_DIR, exist_ok=True)
    libs = build_all(cuda_rans, BUILD_DIR)
    print(cs.nvidia_smi(), flush=True)
    for S, k, C, seed in SHAPES:
        vc, m, s, lower = cs.clamped_message(S, k, seed, C)
        words, flags, hi, lo = cuda_rans.rans_encode(vc, m, s, lower)
        buf, total = IL.compact(words, flags)
        threads, per = cuda_rans.decode_launch_shape(S)
        row = {"S": S, "k": k, "C": C, "seed": seed}
        for name, lib in libs.items():
            vals, h2, l2 = (torch.empty_like(t) for t in (vc, hi, lo))

            def launch(lib=lib, vals=vals, h2=h2, l2=l2):
                err = lib.rans_decode_launch(
                    buf.data_ptr(), buf.shape[-1], total.data_ptr(),
                    hi.data_ptr(), lo.data_ptr(), m.data_ptr(), s.data_ptr(),
                    lower.data_ptr(), vals.data_ptr(), h2.data_ptr(),
                    l2.data_ptr(), C, S, k, threads, per,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            row[f"{name}_ms"] = cs.device_ms(launch, 10, cs.DEC)
            if name == "base" and not torch.equal(vals, vc):
                raise RuntimeError("base variant did not decode the input")
            if name == "count":
                lib.read_misses()
                launch()
                torch.cuda.synchronize()
                row["misses_per_symbol"] = lib.read_misses() / vc.numel()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
