"""Hopper rANS kernels (csrc/rans_kernels.cu): build, binding and wrappers.

Two kernels replace the three Pallas TPU kernels of the JAX package's
`codec/pallas_rans.py`:

- `rans_encode` launches `rans_encode_kernel`, which replaces
  `_encode_kernel` (launched by `pallas_encode_core`): S streams advanced
  over k steps, the CDF evaluated in-kernel, one thread per stream with a
  native uint64_t state.
- `rans_decode` launches `rans_decode_kernel`, which replaces both
  `_decode_kernel` (`pallas_decode_core`, buffer resident in VMEM) and
  `_decode_chunk_kernel` (`_pallas_decode_windowed`, buffer windowed from
  HBM): one CTA per container walks the steps in reverse, ranks the
  refilling streams with a block-wide scan, and reads the words straight
  from global memory, so no windowing is needed at any message length.

What bounds them on an H100: the per-stream dependence over k steps and the
low parallelism of one container (S <= 768 threads at the flagship levels);
they move few bytes.  Batching a queue's containers into one launch is
later work.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version in codec/interleaved.py (`encode_plain`,
`decode_plain`), which computes the same function.  Encode and decode
derive the backend from the same predicate, the device of their tensors, so
a message decodes on the backend that encoded it.

The library is built with nvcc at first use into the package's `build/`
directory, keyed by a hash of the source and flags, and bound with ctypes.
A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import torch

from .interleaved import decode_plain, encode_plain
from .native import CSRC_DIR, build_native

_SRC = os.path.join(CSRC_DIR, "rans_kernels.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
MAX_DECODE_STREAMS = 8192  # 1024 threads x 8 streams per thread

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the rANS kernels cannot be built")


def build() -> str:
    """Compile the kernels (once per source hash) and return the .so path."""
    return build_native(_SRC, _nvcc(), NVCC_FLAGS, "rans_kernels")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            i64 = ctypes.c_int64
            lib.rans_encode_launch.restype = i
            lib.rans_encode_launch.argtypes = [p] * 9 + [i, i, p]
            lib.rans_decode_launch.restype = i
            lib.rans_decode_launch.argtypes = (
                [p, i64] + [p] * 9 + [i, i, i, i, p]
            )
            lib.cdf_eval_launch.restype = i
            lib.cdf_eval_launch.argtypes = [p] * 5 + [i64, p]
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


def _raise_if(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def rans_encode(v: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                lower: torch.Tensor, seeds: Optional[torch.Tensor] = None):
    """Encode [k, S] tiles: window-clamped bins v (int32), means and scales
    (float32), window lower bounds (int32), optional [S] int64 seeds.
    Returns (words [k, S] int64, flags [k, S] int32, hi [S] int64,
    lo [S] int64).  k is a multiple of 16; on the card S is at most
    MAX_DECODE_STREAMS, the most the decode kernel takes."""
    if not v.is_cuda:
        return encode_plain(v, m, s, lower, seeds)
    k, S = v.shape
    # refuse what the card cannot decode, so that no such container is written
    check_streams(S)
    dev = v.device
    for t, name, dt in ((v, "v", torch.int32), (m, "mean", torch.float32),
                        (s, "scale", torch.float32),
                        (lower, "lower", torch.int32)):
        _check(t, name, dt, (k, S), dev)
    if seeds is not None:
        _check(seeds, "seeds", torch.int64, (S,), dev)
    lib = _load()
    words = torch.empty((k, S), dtype=torch.int64, device=dev)
    flags = torch.empty((k, S), dtype=torch.int32, device=dev)
    hi = torch.empty(S, dtype=torch.int64, device=dev)
    lo = torch.empty(S, dtype=torch.int64, device=dev)
    err = lib.rans_encode_launch(
        v.data_ptr(), m.data_ptr(), s.data_ptr(), lower.data_ptr(),
        None if seeds is None else seeds.data_ptr(), words.data_ptr(),
        flags.data_ptr(), hi.data_ptr(), lo.data_ptr(), S, k, _stream(),
    )
    _raise_if(err, "rans_encode_kernel")
    rans_encode.launches += 1
    return words, flags, hi, lo


# launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else
rans_encode.launches = 0


def check_streams(S: int) -> None:
    """Both kernels take 1..MAX_DECODE_STREAMS streams per container."""
    if not 1 <= S <= MAX_DECODE_STREAMS:
        raise ValueError(f"the rANS kernels take 1..{MAX_DECODE_STREAMS} "
                         f"streams, got {S}")


def decode_launch_shape(S: int):
    """(threads, streams per thread) of the one-CTA decode launch."""
    check_streams(S)
    per = 1
    while per * 1024 < S:
        per *= 2
    threads = -(-S // per)
    return -(-threads // 32) * 32, per


def rans_decode(buf: torch.Tensor, num_words, hi: torch.Tensor,
                lo: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                lower: torch.Tensor):
    """Decode [k, S] tiles from the word buffer (int64, holes filled),
    starting at ptr = num_words (int or 0-d int64 tensor) with states
    (hi, lo).  Returns (vals [k, S] int32, hi [S] int64, lo [S] int64)."""
    if not buf.is_cuda:
        return decode_plain(buf, num_words, hi, lo, m, s, lower)
    k, S = m.shape
    dev = buf.device
    nw = torch.as_tensor(num_words, dtype=torch.int64, device=dev).reshape(())
    _check(buf, "buf", torch.int64, (buf.shape[0],), dev)
    _check(hi, "hi", torch.int64, (S,), dev)
    _check(lo, "lo", torch.int64, (S,), dev)
    for t, name, dt in ((m, "mean", torch.float32),
                        (s, "scale", torch.float32),
                        (lower, "lower", torch.int32)):
        _check(t, name, dt, (k, S), dev)
    threads, per = decode_launch_shape(S)
    lib = _load()
    vals = torch.empty((k, S), dtype=torch.int32, device=dev)
    hi_out = torch.empty(S, dtype=torch.int64, device=dev)
    lo_out = torch.empty(S, dtype=torch.int64, device=dev)
    err = lib.rans_decode_launch(
        buf.data_ptr(), buf.shape[0], nw.data_ptr(), hi.data_ptr(),
        lo.data_ptr(), m.data_ptr(), s.data_ptr(), lower.data_ptr(),
        vals.data_ptr(), hi_out.data_ptr(), lo_out.data_ptr(), S, k,
        threads, per, _stream(),
    )
    _raise_if(err, "rans_decode_kernel")
    rans_decode.launches += 1
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
        out.data_ptr(), n, _stream(),
    )
    _raise_if(err, "cdf_eval_kernel")
    return out
