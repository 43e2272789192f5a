"""Coder stress at the reference's own scale: 50M logistic symbols through
the interleaved rANS coder, bit-exact, three ways.

- host in the loop: numpy arrays in, the container's bytes out
  (`interleaved_encode`, `container.pack_streams`), and back
  (`unpack_streams`, `interleaved_decode`) to a numpy array: the rate a
  user of the API observes, transfers and the host state chain included;
- kernel: the interleaved API on tensors already on the device
  (`interleaved_encode` / `interleaved_decode`: layout, the encode
  kernels, compaction, the decode kernel);
- plain: the plain PyTorch coder on the same device tensors
  (`encode_plain`, `compact`, `decode_plain`).

At S = 8192 streams a 50M-symbol message takes k = 6112 steps; its word
buffer (~50 MB) is far larger than the decode kernel's shared-memory ring,
which therefore windows it (`decode_windowed`).  Each device path runs
`--iters` times; every run is timed (CUDA events on the card, the host
clock on the CPU) and checked bit-exact afterwards, and the rate is n over
the median.  The symbols are the draw of the repository's
`demo/run_stress_50m.py` (numpy, seed 6), clamped into the coding window.

    python -m finalproject_losslessimagecompression_tpu_torch.demo.stress \\
        [--n 50000000] [--num-streams 8192] [--iters 3] [--device cpu] \\
        [--out results/torch_h100/stress_50m.json]

On the CPU the kernel path does not exist (a CPU tensor takes the plain
version), so only the host and plain paths run.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..codec import interleaved as IL
from ..codec.cdf import NBINS, lower_bin_np
from ..codec.container import pack_streams, unpack_streams
from ..models.idflow import resolve_device
from ..utils.profiling import device_label
from . import write_new

# shared memory one CTA may hold on an H100 (227 KB, opt-in)
CTA_SMEM_BYTES = 227 * 1024
SEED = 6  # the draw of demo/run_stress_50m.py


def draw(n: int, seed: int = SEED):
    """(v int32, means, scales float32) [n]: logistic symbols on the
    1/256 grid, v clamped into each symbol's 2048-bin window (the draw of
    the repository's stress and bench scripts, by their seeds)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2, 2, n).astype(np.float32)
    scales = np.exp(rng.uniform(-4, 0, n)).astype(np.float32)
    raw = means + scales * rng.logistic(0, 1, n).astype(np.float32)
    v = np.round(raw * 256).astype(np.int32)
    low = lower_bin_np(means)
    return np.clip(v, low, low + NBINS - 1), means, scales


def clock(device):
    """() -> stop(); stop() -> seconds since the start, device work
    included (CUDA events on the card)."""
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()

        def stop():
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        return stop
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


def kernel_round_trip(v, m, s, S: int):
    """The interleaved API on device tensors: (encoded streams, decoded
    values [n])."""
    enc = IL.interleaved_encode(v, m, s, num_streams=S)
    return enc, IL.interleaved_decode(enc, m, s)[0]


def plain_round_trip(v, m, s, S: int):
    """The plain coder on the same tensors: (word buffer, word count, hi,
    lo, decoded values [n])."""
    n = v.numel()
    vc, mk, sk, lower, *_ = IL._prepare_encode(v, m, s, S,
                                               IL._plan_steps(n, S))
    words, flags, hi, lo = IL.encode_plain(vc, mk, sk, lower)
    buf, total = IL.compact(words, flags)
    vals, _, _ = IL.decode_plain(buf, total, hi, lo, mk, sk, lower)
    return buf, total, hi, lo, vals.reshape(-1)[:n]


def _timed_runs(fn, iters: int, device, check):
    """Seconds of `iters` runs of fn (each checked by `check` after its
    clock stopped) and fn's last result."""
    secs, out = [], None
    for _ in range(iters):
        stop = clock(device)
        out = fn()
        secs.append(stop())
        check(out)
    return secs, out


def run(n: int = 50_000_000, num_streams: int = 8192, iters: int = 3,
        device=None, plain: bool = True) -> dict:
    """The three ways (module docstring); `plain=False` leaves out the
    plain path, for a caller that holds the kernels against the plain
    versions on the same message itself."""
    device = resolve_device(device)
    v, means, scales = draw(n)
    S = IL.pick_num_streams(n, num_streams)
    k = IL._plan_steps(n, S)
    out = {
        "what": f"coder stress at the reference's scale: {n} logistic "
                "symbols (the draw of demo/run_stress_50m.py, seed "
                f"{SEED}), bit-exact required",
        "n_symbols": n,
        "device": device_label(device),
        "num_streams": S,
        "steps": k,
    }

    # host in the loop: numpy in, container bytes out, and back
    t0 = time.perf_counter()
    enc = IL.interleaved_encode(
        torch.from_numpy(v).to(device), torch.from_numpy(means).to(device),
        torch.from_numpy(scales).to(device), num_streams=S)
    blob = pack_streams(enc)
    t_enc = time.perf_counter() - t0
    # the encoder's word count (the container's state chain may place a
    # boundary word on either side, so its parse can count one more)
    num_words = int(enc.num_words)
    t0 = time.perf_counter()
    back = unpack_streams(blob)
    dec = IL.interleaved_decode(back, torch.from_numpy(means).to(device),
                                torch.from_numpy(scales).to(device))[0]
    dec = dec.cpu().numpy()
    t_dec = time.perf_counter() - t0
    out["bit_exact"] = bool(np.array_equal(dec, v))
    out["host_encode_s"] = t_enc
    out["host_decode_s"] = t_dec
    out["host_sym_per_s"] = 2 * n / (t_enc + t_dec)
    out["num_words"] = num_words
    out["coded_bits_per_sym"] = 32.0 * num_words / n
    out["container_bits_per_sym"] = 8.0 * len(blob) / n
    out["decode_windowed"] = (4 * num_words > CTA_SMEM_BYTES
                              if device.type == "cuda" else None)
    del enc, back, dec
    if not out["bit_exact"]:
        raise SystemExit("host round trip NOT bit-exact")

    # device paths on the same device tensors
    vd, md, sd = (torch.from_numpy(a).to(device) for a in (v, means, scales))

    def exact(vals):
        if not torch.equal(vals, vd):
            raise SystemExit("device round trip NOT bit-exact")

    paths = ({"plain": lambda: plain_round_trip(vd, md, sd, S)} if plain
             else {})
    if device.type == "cuda":
        paths = {"kernel": lambda: kernel_round_trip(vd, md, sd, S),
                 **paths}
    results = {}
    for name, fn in paths.items():
        secs, res = _timed_runs(fn, iters, device,
                                lambda r: exact(r[-1]))
        out[f"{name}_bit_exact"] = True
        out[f"{name}_samples_s"] = secs
        out[f"{name}_device_sym_per_s"] = n / statistics.median(secs)
        results[name] = res
        print(name, out[f"{name}_device_sym_per_s"], "sym/s")
    if "kernel" in results and "plain" in results:
        enc, _ = results["kernel"]
        buf, total, hi, lo, _ = results["plain"]
        # the kernels' container equals the plain coder's word for word
        out["kernel_equals_plain"] = bool(
            torch.equal(enc.words, buf.reshape(-1))
            and int(enc.num_words) == int(total)
            and torch.equal(enc.state_hi, hi.reshape(-1))
            and torch.equal(enc.state_lo, lo.reshape(-1)))
        if not out["kernel_equals_plain"]:
            raise SystemExit("kernel container differs from the plain one")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50_000_000)
    ap.add_argument("--num-streams", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                    "the CPU)")
    ap.add_argument("--out", default=None,
                    help="a new JSON file for the result")
    args = ap.parse_args(argv)
    out = run(args.n, args.num_streams, args.iters, args.device)
    print({k: out[k] for k in ("bit_exact", "host_sym_per_s",
                               "coded_bits_per_sym")})
    if args.out:
        write_new(args.out, out)
    return out


if __name__ == "__main__":
    main()
