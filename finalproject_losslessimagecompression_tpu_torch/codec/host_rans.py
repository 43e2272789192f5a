"""The host C++ rANS coder (csrc/rans_host.cpp), bound with ctypes.

The port's counterpart of the JAX package's `native` module: a
single-stream coder with the oracle's semantics (`codec/oracle.py`) and an
S-stream interleaved coder over one global word buffer, for hosts without
a card.  `chain_pack` / `chain_unpack` are the LIC2 state chain of
`codec/container.py` (csrc/chain.cpp).  This is host code, not a kernel.

The library is built with g++ at first use into the package's `build/`
(`codec/native.py:build_native`); a failed build raises with the
compiler's message.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import numpy as np

from .container import chain_pack, chain_unpack
from .native import CSRC_DIR, build_native

__all__ = ["encode_single", "decode_single", "encode_interleaved",
           "decode_interleaved", "chain_pack", "chain_unpack"]

_SRC = os.path.join(CSRC_DIR, "rans_host.cpp")
_lock = threading.Lock()
_lib = None


def _load():
    """Build (once per source hash) and bind csrc/rans_host.cpp."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_native(
                _SRC, "g++", ["-O3", "-fPIC", "-shared", "-std=c++17"],
                "rans_host"))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.rans_encode_single.restype = i
            lib.rans_encode_single.argtypes = [i, p, p, p, p, i, p]
            lib.rans_decode_single.restype = i
            lib.rans_decode_single.argtypes = [i, p, p, p, i, p, p]
            lib.rans_encode_interleaved.restype = i
            lib.rans_encode_interleaved.argtypes = [i, i, p, p, p, p, i, p,
                                                    p]
            lib.rans_decode_interleaved.restype = i
            lib.rans_decode_interleaved.argtypes = [i, i, p, p, p, i, p, p,
                                                    p]
            _lib = lib
        return _lib


def _as(arr, dtype) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr), dtype=dtype)


def _symbols(values, means, scales):
    v, m, s = _as(values, np.int32), _as(means, np.float32), _as(
        scales, np.float32)
    if not v.shape == m.shape == s.shape or v.ndim != 1:
        raise ValueError("values, means and scales must be 1-D and equal "
                         "in length")
    return v, m, s


def encode_single(values, means, scales,
                  state: int = 1 << 32) -> Tuple[int, np.ndarray]:
    """Encode the bins `values` in order from `state`: (final state,
    emitted 32-bit words in emission order)."""
    v, m, s = _symbols(values, means, scales)
    out = np.empty(v.shape[0] + 16, np.uint32)
    st = ctypes.c_uint64(state)
    nw = _load().rans_encode_single(
        v.shape[0], v.ctypes.data, m.ctypes.data, s.ctypes.data,
        out.ctypes.data, out.shape[0], ctypes.addressof(st))
    if nw < 0:
        raise ValueError("host encode failed (symbol out of window?)")
    return int(st.value), out[:nw].copy()


def decode_single(state: int, words, n: int, means,
                  scales) -> Tuple[int, np.ndarray]:
    """Decode n bins; `means` / `scales` in decode (reversed) order, words
    consumed newest first: (final state, values in decode order)."""
    w = _as(words, np.uint32)
    m, s = _as(means, np.float32), _as(scales, np.float32)
    if m.shape != (n,) or s.shape != (n,):
        raise ValueError("means and scales must hold n values")
    out = np.empty(n, np.int32)
    st = ctypes.c_uint64(state)
    r = _load().rans_decode_single(
        n, m.ctypes.data, s.ctypes.data, w.ctypes.data, w.shape[0],
        out.ctypes.data, ctypes.addressof(st))
    if r < 0:
        raise ValueError("host decode failed (buffer underrun)")
    return int(st.value), out


def encode_interleaved(values, means, scales, num_streams: int):
    """S-stream encode of inputs pre-padded to steps * S symbols (symbol i
    to stream i % S): (words, state hi uint32 [S], state lo uint32 [S])."""
    v, m, s = _symbols(values, means, scales)
    S = num_streams
    if v.shape[0] % S:
        raise ValueError("the symbol count must be a multiple of S")
    out = np.empty(v.shape[0] + 16, np.uint32)
    hi, lo = np.empty(S, np.uint32), np.empty(S, np.uint32)
    nw = _load().rans_encode_interleaved(
        v.shape[0] // S, S, v.ctypes.data, m.ctypes.data, s.ctypes.data,
        out.ctypes.data, out.shape[0], hi.ctypes.data, lo.ctypes.data)
    if nw < 0:
        raise ValueError("host interleaved encode failed")
    return out[:nw].copy(), hi, lo


def decode_interleaved(words, means, scales, num_streams: int, hi, lo):
    """Inverse of encode_interleaved, means / scales in encode order:
    (values, final state hi, final state lo)."""
    w = _as(words, np.uint32)
    m, s = _as(means, np.float32), _as(scales, np.float32)
    S = num_streams
    if m.shape != s.shape or m.ndim != 1 or m.shape[0] % S:
        raise ValueError("means and scales must hold steps * S values")
    hi, lo = _as(hi, np.uint32).copy(), _as(lo, np.uint32).copy()
    if hi.shape != (S,) or lo.shape != (S,):
        raise ValueError("hi and lo must hold S states")
    out = np.empty(m.shape[0], np.int32)
    r = _load().rans_decode_interleaved(
        m.shape[0] // S, S, m.ctypes.data, s.ctypes.data, w.ctypes.data,
        w.shape[0], out.ctypes.data, hi.ctypes.data, lo.ctypes.data)
    if r < 0:
        raise ValueError("host interleaved decode failed")
    return out, hi, lo
