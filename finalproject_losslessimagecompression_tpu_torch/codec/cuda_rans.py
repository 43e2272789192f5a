"""Hopper rANS kernels (csrc/rans_kernels.cu): build, binding and wrappers.

Three kernels replace the three Pallas TPU kernels of the JAX package's
`codec/pallas_rans.py`:

- `rans_cdf_prepass` launches `rans_cdf_prepass_kernel`, which takes the
  CDF evaluation of `_encode_kernel` out of the serial chain: one thread per
  symbol writes (1 / freq as float64, c_start, freq).
- `rans_encode` launches the prepass and then `rans_encode_kernel`, which
  replaces the state loop of `_encode_kernel` (launched by
  `pallas_encode_core`): one thread per stream with a native uint64_t state
  and an exact float64-reciprocal division.
- `rans_decode` launches `rans_decode_kernel`, which replaces both
  `_decode_kernel` (`pallas_decode_core`, buffer resident in VMEM) and
  `_decode_chunk_kernel` (`_pallas_decode_windowed`, buffer windowed from
  HBM): one CTA per container walks the steps in reverse, ranks the
  refilling streams with warp ballots and one barrier per step, pops the
  words from a shared-memory ring that cp.async keeps filled, and finds
  each symbol from an inverse-CDF guess and a verified bracket.

Each wrapper takes one container ([k, S] tiles) or C containers of the same
(S, k) ([C, k, S]), coded by one launch: a serving queue launches each
kernel once per level.  What bounds them on an H100: the per-stream
dependence over k steps (latency for the small containers, issue rate for
the large ones: a container is one CTA on one SM); they move few bytes.

Launch counts.  Each wrapper's `launches` adds one where it launches its
kernel and nowhere else (`utils.graphs.count_launch`).  A launch made
while a CUDA graph is captured (inside `utils.graphs.record_launches`) is
tallied into the capture instead, and `utils.graphs.CountedGraph.replay`
adds the graph's tally to the counters on every replay, since a replay
runs no Python.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version in codec/interleaved.py (`encode_plain`,
`decode_plain`, `cdf_prepass_plain`), which computes the same function.
Encode and decode derive the backend from the same predicate, the device of
their tensors, so a message decodes on the backend that encoded it.

The library is built with nvcc at first use into the package's `build/`
directory, keyed by a hash of the source and flags (`native.build_native`),
and bound with ctypes.
A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from typing import Optional

import torch

from ..utils.graphs import count_launch
from .interleaved import cdf_prepass_plain, decode_plain, encode_plain
from .native import (
    CSRC_DIR,
    build_native,
    check_launch,
    find_nvcc,
    stream,
)

_SRC = os.path.join(CSRC_DIR, "rans_kernels.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
MAX_DECODE_STREAMS = 8192  # 1024 threads x 8 streams per thread

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile the kernels (once per source hash) and return the .so path."""
    return build_native(_SRC, find_nvcc(), NVCC_FLAGS, "rans_kernels")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            i64, f32 = ctypes.c_int64, ctypes.c_float
            lib.rans_cdf_prepass_launch.restype = i
            lib.rans_cdf_prepass_launch.argtypes = [p] * 5 + [i64, p]
            lib.rans_encode_launch.restype = i
            lib.rans_encode_launch.argtypes = [p] * 6 + [i, i, i, p]
            lib.rans_decode_launch.restype = i
            lib.rans_decode_launch.argtypes = (
                [p, i64] + [p] * 9 + [i] * 5 + [p]
            )
            lib.cdf_eval_launch.restype = i
            lib.cdf_eval_launch.argtypes = [p] * 5 + [i64, p]
            lib.depth_probe_launch.restype = i
            lib.depth_probe_launch.argtypes = [i, i, f32, f32, i, i, p, p]
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def rans_cdf_prepass(v: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                     lower: torch.Tensor) -> torch.Tensor:
    """Coding records of window-clamped bins v (int32), means and scales
    (float32) and window lower bounds (int32), all of one shape: int64
    [..., 2] holding the float64 bits of 1 / freq, then
    c_start | freq << 32 (`interleaved.unpack_prepass` splits them)."""
    if not v.is_cuda:
        return cdf_prepass_plain(v, m, s, lower)
    dev = v.device
    for t, name, dt in ((v, "v", torch.int32), (m, "mean", torch.float32),
                        (s, "scale", torch.float32),
                        (lower, "lower", torch.int32)):
        _check(t, name, dt, v.shape, dev)
    rec = torch.empty((*v.shape, 2), dtype=torch.int64, device=dev)
    err = _load().rans_cdf_prepass_launch(
        v.data_ptr(), m.data_ptr(), s.data_ptr(), lower.data_ptr(),
        rec.data_ptr(), v.numel(), stream(),
    )
    check_launch(err, "rans_cdf_prepass_kernel")
    count_launch(rans_cdf_prepass)
    return rec


# launch counts: each wrapper adds one where it launches its kernel (or to
# the tally of a capture in progress), and nowhere else
rans_cdf_prepass.launches = 0


def rans_encode(v: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                lower: torch.Tensor, seeds: Optional[torch.Tensor] = None):
    """Encode [k, S] tiles, or C containers of [C, k, S] tiles, in one
    launch: window-clamped bins v (int32), means and scales (float32),
    window lower bounds (int32), optional [S] / [C, S] int64 seeds.
    Returns (words int64 and flags int32 shaped like v, hi and lo int64
    shaped like the seeds).  k is a multiple of 16; on the card S is at
    most MAX_DECODE_STREAMS, the most the decode kernel takes."""
    k, S = v.shape[-2:]
    C = math.prod(v.shape[:-2])
    if not v.is_cuda:
        # streams are independent, so C containers code as one of C * S
        # streams: [C, k, S] -> [k, C * S] and back
        def flat(t):
            return t.reshape(C, k, S).transpose(0, 1).reshape(k, C * S)

        def back(t):
            return t.reshape(k, C, S).transpose(0, 1).reshape(v.shape)

        words, flags, hi, lo = encode_plain(
            flat(v), flat(m), flat(s), flat(lower),
            None if seeds is None else seeds.reshape(C * S))
        lead = (*v.shape[:-2], S)
        return back(words), back(flags), hi.reshape(lead), lo.reshape(lead)
    # refuse what the card cannot decode, so that no such container is written
    check_streams(S)
    dev = v.device
    if seeds is not None:
        _check(seeds, "seeds", torch.int64, (*v.shape[:-2], S), dev)
    rec = rans_cdf_prepass(v, m, s, lower)
    words = torch.empty(v.shape, dtype=torch.int64, device=dev)
    flags = torch.empty(v.shape, dtype=torch.int32, device=dev)
    hi = torch.empty((*v.shape[:-2], S), dtype=torch.int64, device=dev)
    lo = torch.empty_like(hi)
    err = _load().rans_encode_launch(
        rec.data_ptr(), None if seeds is None else seeds.data_ptr(),
        words.data_ptr(), flags.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        C, S, k, stream(),
    )
    check_launch(err, "rans_encode_kernel")
    count_launch(rans_encode)
    return words, flags, hi, lo


rans_encode.launches = 0


def check_streams(S: int) -> None:
    """The kernels take 1..MAX_DECODE_STREAMS streams per container."""
    if not 1 <= S <= MAX_DECODE_STREAMS:
        raise ValueError(f"the rANS kernels take 1..{MAX_DECODE_STREAMS} "
                         f"streams, got {S}")


def decode_launch_shape(S: int):
    """(threads, streams per thread) of a container's CTA."""
    check_streams(S)
    per = 1
    while per * 1024 < S:
        per *= 2
    threads = -(-S // per)
    return -(-threads // 32) * 32, per


# steps between a ring refill's copy and the words' first use, by streams
# per thread (the DEPTH of `launch_decode`'s instantiations in the source)
_RING_DEPTH = {1: 2, 2: 2, 4: 1, 8: 1}


def decode_ring_words(S: int) -> int:
    """32-bit words of the decode kernel's shared-memory ring at S streams:
    the least power of two above (DEPTH + 2) * S.  A container whose word
    buffer is longer streams through the ring (the windowed decode)."""
    ring = 1
    while ring <= (_RING_DEPTH[decode_launch_shape(S)[1]] + 2) * S:
        ring <<= 1
    return ring


def rans_decode(buf: torch.Tensor, num_words, hi: torch.Tensor,
                lo: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                lower: torch.Tensor):
    """Decode [k, S] tiles from the word buffer [nbuf] (int64, holes
    filled), starting at ptr = num_words (int or 0-d int64 tensor) with
    states (hi, lo) [S]; or C containers in one launch: buf [C, nbuf],
    num_words [C], hi, lo [C, S], tiles [C, k, S].  Returns (vals int32
    shaped like m, hi and lo int64 shaped like the input states)."""
    k, S = m.shape[-2:]
    C = math.prod(m.shape[:-2])
    if not buf.is_cuda:
        if m.dim() == 2:
            return decode_plain(buf, num_words, hi, lo, m, s, lower)
        outs = [decode_plain(buf[c], num_words[c], hi[c], lo[c], m[c], s[c],
                             lower[c]) for c in range(C)]
        return tuple(torch.stack(x) for x in zip(*outs))
    dev = buf.device
    lead = tuple(m.shape[:-2])
    nw = torch.as_tensor(num_words, dtype=torch.int64,
                         device=dev).reshape(lead)
    _check(nw, "num_words", torch.int64, lead, dev)
    _check(buf, "buf", torch.int64, (*lead, buf.shape[-1]), dev)
    _check(hi, "hi", torch.int64, (*lead, S), dev)
    _check(lo, "lo", torch.int64, (*lead, S), dev)
    for t, name, dt in ((m, "mean", torch.float32),
                        (s, "scale", torch.float32),
                        (lower, "lower", torch.int32)):
        _check(t, name, dt, m.shape, dev)
    threads, per = decode_launch_shape(S)
    vals = torch.empty(m.shape, dtype=torch.int32, device=dev)
    hi_out = torch.empty_like(hi)
    lo_out = torch.empty_like(lo)
    err = _load().rans_decode_launch(
        buf.data_ptr(), buf.shape[-1], nw.data_ptr(), hi.data_ptr(),
        lo.data_ptr(), m.data_ptr(), s.data_ptr(), lower.data_ptr(),
        vals.data_ptr(), hi_out.data_ptr(), lo_out.data_ptr(), C, S, k,
        threads, per, stream(),
    )
    check_launch(err, "rans_decode_kernel")
    count_launch(rans_decode)
    return vals, hi_out, lo_out


rans_decode.launches = 0


def cdf_eval(v: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
             lower: torch.Tensor) -> torch.Tensor:
    """The kernels' own CDF at flat CUDA tensors (int64 result); used to
    measure its agreement with `cdf.cdf_bits` on the card.  Not on the
    coding path, so it has no launch counter."""
    n = v.numel()
    dev = v.device
    for t, name, dt in ((v, "v", torch.int32), (m, "mean", torch.float32),
                        (s, "scale", torch.float32),
                        (lower, "lower", torch.int32)):
        _check(t, name, dt, (n,), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    err = _load().cdf_eval_launch(
        v.data_ptr(), m.data_ptr(), s.data_ptr(), lower.data_ptr(),
        out.data_ptr(), n, stream(),
    )
    check_launch(err, "cdf_eval_kernel")
    return out


DEPTH_PROBES = {"decode": 0, "encode": 1}


def depth_probe(kind: str, steps: int, out: torch.Tensor) -> None:
    """Run `steps` dependent steps of the decode or encode chain's
    irreducible part on one warp (decode: one CDF evaluation and the 64-bit
    multiply-add; encode: the renormalisation compare, the reciprocal
    division and the multiply-add), writing the 32 final states to `out`
    (int64 [32] on the card).  Timed by the caller; measurement only, so it
    has no launch counter."""
    _check(out, "out", torch.int64, (32,), out.device)
    err = _load().depth_probe_launch(
        DEPTH_PROBES[kind], steps, 0.1, 0.7, -998, 4099, out.data_ptr(),
        stream())
    check_launch(err, "depth_probe_kernel")
