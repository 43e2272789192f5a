#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to account.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   the card's name and power limit (nvidia-smi), CUDA version, and
            the time to build the rANS kernels (nvcc) and the container
            state chain (g++), built in parallel from csrc/.
2. kernels  both rANS kernels against their plain PyTorch versions on the
            same CUDA tensors at the flagship level shapes (S=384, k=256 and
            S=768, k=64), with and without bits-back seeds, with
            out-of-window symbols: words, flags, states and decoded values
            must be bit-identical, and the decode must return the input with
            every state back at 2^32 | seed.
3. e2e      the main path at full width: FlowCodec over the flagship IDFlow
            (64x64x3, nflows 8, nsplit 3, DenseBlocks of growth 512 and
            depth 12), random weights from a seed with every projection
            perturbed off zero, compress_many then decompress_many(fetch=True)
            on a queue of 4 batches of 16 images; bit-exact, with launch
            counts taken over exactly that run; then a torch.profiler pass
            over one more queue (device time by kernel, idle share).
4. large    an 8M-symbol message (S=8192, k=1024): the kernels against their
            plain versions as in phase 2, then the whole encode and decode
            timed, bit-exact.

Then the `kernels` summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; with
no CUDA device, or outside the repository, it exits non-zero and prints no
result.  `--quick` runs phases 1 and 2 only.
"""

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CDF_FLOPS = 10  # float32 ops of one CDF evaluation (codec/cdf.py)
SOURCE = "finalproject_losslessimagecompression_tpu_torch/csrc/rans_kernels.cu"
TPU_KERNELS = "finalproject_losslessimagecompression_tpu/codec/pallas_rans.py"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and float32
    operations over the float32 peak."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device():
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        container,
        cuda_rans,
    )

    t0 = time.time()
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    builds = [threading.Thread(target=run, args=(f,))
              for f in (cuda_rans.build, container._chain)]
    for th in builds:
        th.start()
    for th in builds:
        th.join()
    if errors:
        raise errors[0]
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": round(time.time() - t0, 3)})
    return smi


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def message(n: int, seed: int, dev):
    """n symbols (bins v, means, scales) drawn from a seeded logistic model
    whose scales span the prior's range; every 997th symbol is pushed out
    of its window, and wide scales push out more."""
    g = np.random.default_rng(seed)
    means = g.uniform(-1.0, 1.0, n).astype(np.float32)
    scales = np.exp(g.uniform(-6.24, 1.0, n)).astype(np.float32)
    v = np.round((means + scales * g.logistic(0, 1, n)) * 256).astype(np.int32)
    v[::997] += 3000
    return [torch.from_numpy(a).to(dev) for a in (v, means, scales)]


def kernel_case(S: int, k: int, seeded: bool, seed: int):
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        interleaved as IL,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.cdf import (
        NBINS,
        cdf_bits,
        lower_bin,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.cuda_rans import (
        cdf_eval,
        rans_decode,
        rans_encode,
    )

    dev = torch.device("cuda")
    n = S * k
    v, m, s = (t.reshape(k, S) for t in message(n, seed, dev))
    lower = lower_bin(m)
    vc = torch.minimum(torch.maximum(v, lower), lower + NBINS - 1)
    seeds = None
    if seeded:
        g = torch.Generator(device=dev).manual_seed(seed)
        seeds = torch.randint(0, 2**32, (S,), generator=g, device=dev,
                              dtype=torch.int64)

    # the kernels' CDF against torch's on the card, at the coded bins and
    # at random window positions
    pos = torch.cat([vc - 1, vc, lower - 1 + torch.randint(
        0, NBINS + 1, vc.shape, device=dev, dtype=torch.int32)]).reshape(-1)
    rep = lambda t: t.reshape(-1).repeat(3)  # noqa: E731
    ck = cdf_eval(pos, rep(m), rep(s), rep(lower))
    ct = cdf_bits(pos.reshape(-1), rep(m), rep(s), rep(lower))
    cdf_agree = float((ck == ct).float().mean())
    # the kernels are held to the plain coder bit for bit, which needs the
    # same CDF on both sides: any disagreement is a fault of this build
    assert cdf_agree == 1.0, (
        f"kernel CDF agrees with cdf_bits on only {cdf_agree:.6f} of "
        f"evaluations (S={S}, k={k})")

    wk, fk, hk, lk = rans_encode(vc, m, s, lower, seeds)
    wp, fp, hp, lp = IL.encode_plain(vc, m, s, lower, seeds)
    enc_err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in ((wk, wp), (fk, fp), (hk, hp), (lk, lp)))
    assert enc_err == 0, f"encode kernel differs from plain (S={S}, k={k})"

    buf, total = IL.compact(wk, fk)
    vk, h2, l2 = rans_decode(buf, total, hk, lk, m, s, lower)
    assert torch.equal(vk, vc), "decode kernel did not return the input"
    assert bool((h2 == 1).all()), "decode kernel: hi did not return to 1"
    want_lo = seeds if seeded else torch.zeros_like(l2)
    assert torch.equal(l2, want_lo), "decode kernel: lo did not return"
    vp, h3, l3 = IL.decode_plain(buf, total, hk, lk, m, s, lower)
    dec_err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in ((vk, vp), (h2, h3), (l2, l3)))
    assert dec_err == 0, f"decode kernel differs from plain (S={S})"

    enc_ms = cuda_ms(lambda: rans_encode(vc, m, s, lower, seeds), 20)
    enc_plain_ms = cuda_ms(lambda: IL.encode_plain(vc, m, s, lower, seeds), 2)
    dec_ms = cuda_ms(lambda: rans_decode(buf, total, hk, lk, m, s, lower), 20)
    dec_plain_ms = cuda_ms(
        lambda: IL.decode_plain(buf, total, hk, lk, m, s, lower), 1)
    nw = int(total)
    # bytes the function must move, each input read once and each output
    # written once, at the data's own widths (not the kernels' int64
    # interface buffers): 4 B per bin, mean, scale and lower bound, per
    # decoded value and per 32-bit seed, word and state limb; 1 B per
    # emission flag; only the nw words this message emits
    enc_bytes = n * (4 + 4 + 4 + 4) + (4 * S if seeded else 0) \
        + 4 * nw + n * 1 + 2 * 4 * S
    dec_bytes = 4 * nw + 4 + 2 * 4 * S + n * (4 + 4 + 4) + n * 4 + 2 * 4 * S
    enc_bound = bound(enc_bytes, 2 * CDF_FLOPS * n)
    dec_bound = bound(dec_bytes, 13 * CDF_FLOPS * n)
    row = {"S": S, "k": k, "seeded": seeded, "cdf_agreement": cdf_agree,
           "num_words": nw,
           "encode": {"ms": enc_ms, "plain_ms": enc_plain_ms,
                      "bound_ms": enc_bound[0], "bound_by": enc_bound[1],
                      "max_abs_err": enc_err},
           "decode": {"ms": dec_ms, "plain_ms": dec_plain_ms,
                      "bound_ms": dec_bound[0], "bound_by": dec_bound[1],
                      "max_abs_err": dec_err}}
    emit({"phase": "kernels", **row})
    return row


def phase_kernels():
    rows = []
    for i, (S, k) in enumerate(((384, 256), (768, 64))):
        for seeded in (False, True):
            rows.append(kernel_case(S, k, seeded, seed=100 + 2 * i + seeded))
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def flagship_codec():
    from finalproject_losslessimagecompression_tpu_torch.models import (
        CouplingCfg,
        DenseBlockCfg,
        FlowCfg,
        FlowCodec,
        IDFlow,
    )

    cfg = FlowCfg(
        H=64, W=64, C=3, nflows=8, nsplit=3,
        couple=CouplingCfg(0.75, DenseBlockCfg(512, 12, "ReLU", "float32")),
        prior_nn=DenseBlockCfg(512, 12, "ReLU", "float32"),
    )
    model = IDFlow(cfg, device="cuda", seed=0).eval()
    # fresh projections are zero, which would make every shift and prior
    # trivial: perturb them from a seeded generator
    g = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".proj." in name:
                p.add_(0.01 * torch.randn(p.shape, generator=g).to(p.device))
    return cfg, model, FlowCodec(model, num_streams=8192)


def images(batch: int, queue: int, seed: int = 1):
    """Synthetic images on the 1/256 grid, uniform noise (as bench.py)."""
    rng = np.random.default_rng(seed)
    return [
        (np.round(rng.uniform(0, 1, (batch, 64, 64, 3)) * 256).astype(
            np.float32) / 256.0)
        for _ in range(queue)
    ]


def phase_e2e(batch: int = 16, queue: int = 4):
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        cuda_rans,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.container import (
        pack_streams_many,
    )
    from finalproject_losslessimagecompression_tpu_torch.models.idflow import (
        log_likelihood,
    )

    cfg, model, codec = flagship_codec()
    xs_np = images(batch, queue)
    xs = [torch.from_numpy(x).cuda() for x in xs_np]
    # warm-up pass: cuDNN handles, allocator, kernel libraries
    codec.decompress_many(codec.compress_many(xs), fetch=True)
    torch.cuda.synchronize()

    for wrapper in (cuda_rans.rans_encode, cuda_rans.rans_decode):
        wrapper.launches = 0
    t0 = time.time()
    packed = codec.compress_many(xs)
    recs = codec.decompress_many(packed, fetch=True)
    wall = time.time() - t0
    launches = {"rans_encode_kernel": cuda_rans.rans_encode.launches,
                "rans_decode_kernel": cuda_rans.rans_decode.launches}
    assert all(v > 0 for v in launches.values()), launches
    exact = all(np.array_equal(r, x) for r, x in zip(recs, xs_np))
    assert exact, "main path round trip is not bit-exact"
    real_bpd = float(np.mean([codec.real_bpd(b, i) for b, i in packed]))
    with torch.no_grad():
        lat, means, logscales = model(xs[0])
        lp, _ = log_likelihood(cfg, lat, means, logscales)
        analytic_bpd = float(-lp.mean()) / math.log(2.0)
    assert all(bool(torch.isfinite(t).all()) for t in lat + means + logscales)
    assert [tuple(t.shape[1:]) for t in lat] == [
        tuple(s) for s in model.latent_shapes]

    # phase split of one more queue pass, each fenced with synchronize and
    # timed with CUDA events
    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b) / 1e3

    per_batch, t_enc = timed(
        lambda: [codec._compress_deferred(x) for x in xs])
    flat = [e for encs, _ in per_batch for e in encs]
    blobs, t_pack = timed(lambda: pack_streams_many(flat))
    nl = cfg.nsplit
    packed2 = [(blobs[i * nl:(i + 1) * nl], info)
               for i, (_, info) in enumerate(per_batch)]
    outs, t_dec = timed(
        lambda: [codec._decompress_deferred(b, i) for b, i in packed2])
    _, t_verify = timed(lambda: codec._check_got(
        [bool(torch.stack([ok for _, oks in outs for ok in oks]).all())]))
    res = {"phase": "e2e", "batch": batch, "queue": queue,
           "bit_exact": exact, "real_bpd": real_bpd,
           "analytic_bpd": analytic_bpd,
           "images_per_s": batch * queue / wall, "wall_s": wall,
           "phases_s": {"encode": t_enc, "pack": t_pack, "decode": t_dec,
                        "verify": t_verify},
           "launches": launches,
           "streams_per_level": [codec._level_S(lv, batch)
                                 for lv in range(nl)]}
    emit(res)
    profile_pass(codec, xs, wall)
    return res


def profile_pass(codec, xs, unprofiled_wall: float, top: int = 12):
    """torch.profiler over one queue pass: device time by kernel name and
    the share of wall time the device sat idle, against the profiled pass's
    own wall time and against the unprofiled pass's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        codec.decompress_many(codec.compress_many(xs), fetch=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
    # kernels only: operator entries carry their kernels' time as well
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: -e.self_device_time_total)
    emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall,
          "device_idle_share_unprofiled": 1.0 - busy_us / 1e6
          / unprofiled_wall,
          "top": [{"name": e.key[:80], "device_ms": e.self_device_time_total
                   / 1e3, "calls": e.count} for e in events[:top]]})


# ---------------------------------------------------------------------------
# phase 4: an 8M-symbol message
# ---------------------------------------------------------------------------


def phase_large(n: int = 8 * 2**20):
    """The kernels against their plain versions on an 8M-symbol message,
    then the whole encode and decode (layout, kernels, compaction) timed."""
    row = kernel_case(8192, n // 8192, seeded=False, seed=7)
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        interleaved as IL,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.cdf import (
        NBINS,
        lower_bin,
    )

    v, m, s = message(n, seed=7, dev="cuda")
    lower = lower_bin(m)
    vc = torch.minimum(torch.maximum(v, lower), lower + NBINS - 1)
    enc = IL.interleaved_encode(v, m, s, num_streams=8192)
    vals, hi, lo = IL.interleaved_decode(enc, m, s)
    assert enc.num_streams == 8192 and IL._plan_steps(n, 8192) == 1024
    # the coder returns the window-clamped bins; the escapes' true values
    # ride in the container side channel
    assert int(enc.oow_count) == int((vc != v).sum())
    assert torch.equal(vals, vc), "8M-symbol decode is not bit-exact"
    assert bool((hi == 1).all()) and bool((lo == 0).all())
    enc_ms = cuda_ms(lambda: IL.interleaved_encode(v, m, s, 8192), 3)
    dec_ms = cuda_ms(lambda: IL.interleaved_decode(enc, m, s), 3)
    res = {"phase": "large", "symbols": n, "S": 8192, "k": 1024,
           "bit_exact": True, "num_words": int(enc.num_words),
           "encode_ms": enc_ms, "decode_ms": dec_ms,
           "encode_symbols_per_s": n / (enc_ms / 1e3),
           "decode_symbols_per_s": n / (dec_ms / 1e3)}
    emit(res)
    return row


# ---------------------------------------------------------------------------


def kernels_line(rows, e2e):
    head = [r for r in rows if r["S"] == 384 and not r["seeded"]][0]
    out = []
    for key, name, replaces, extra in (
        ("encode", "rans_encode_kernel", f"{TPU_KERNELS}:199", {}),
        ("decode", "rans_decode_kernel", f"{TPU_KERNELS}:347",
         {"also_replaces": f"{TPU_KERNELS}:382"}),
    ):
        h = head[key]
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, **extra,
            "launches": e2e["launches"][name] if e2e else None,
            "max_abs_err": max(r[key]["max_abs_err"] for r in rows),
            "matches_plain": all(r[key]["max_abs_err"] == 0 for r in rows),
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": None,
            "shapes": [{"S": r["S"], "k": r["k"], "seeded": r["seeded"],
                        "ms": r[key]["ms"], "plain_ms": r[key]["plain_ms"],
                        "bound_ms": r[key]["bound_ms"]} for r in rows],
        })
    return {"kernels": out}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = phase_device()
    rows = phase_kernels()
    e2e = None
    if "--quick" not in argv:
        e2e = phase_e2e()
        rows.append(phase_large())
    emit(kernels_line(rows, e2e))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
