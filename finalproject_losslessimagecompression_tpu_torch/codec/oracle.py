"""Single-stream rANS oracle in NumPy/Python integers.

The port's own copy of the JAX package's `codec/oracle.py`: 64-bit state
renormalized into [2^32, 2^64) emitting 32-bit words, M = 2^24 precision,
symbols modelled by the quantized logistic CDF over a 2048-bin window,
decode by binary search.

It is the golden model for the port's interleaved coder (each stream is
this coder) and the host C++ coder (`codec/host_rans.py`): slow (a pure
Python loop) but unambiguous.  Python integers are unbounded, so there is
no overflow subtlety here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .cdf import NBINS, PRECISION_BITS, cdf_bits_np, lower_bin_np

RANS_L = 1 << 32  # lower bound of the renormalization interval
_MASK32 = (1 << 32) - 1
_MASK24 = (1 << 24) - 1


def rans_encode_np(
    state: int,
    values: np.ndarray,
    means: np.ndarray,
    scales: np.ndarray,
    cdf_eval=None,
) -> Tuple[int, List[int]]:
    """Encode integer-bin symbols ``values`` (v = round(x*256)) in order.

    ``cdf_eval(v, mean, scale, lower) -> uint32`` may be injected to pin the
    CDF backend (e.g. torch's `cdf_bits`) -- exp ULPs differ across
    backends, and encode/decode must share one evaluation.  Defaults to the
    NumPy twin.

    Returns (final_state, emitted 32-bit words in emission order).
    """
    values = np.asarray(values, np.int32)
    means = np.asarray(means, np.float32)
    scales = np.asarray(scales, np.float32)
    cdf_eval = cdf_eval or cdf_bits_np
    lower = lower_bin_np(means)
    start = np.asarray(cdf_eval(values - 1, means, scales, lower)).astype(
        np.uint64
    )
    end = np.asarray(cdf_eval(values, means, scales, lower)).astype(np.uint64)
    freq = end - start

    words: List[int] = []
    for i in range(values.shape[0]):
        f = int(freq[i])
        c = int(start[i])
        if f <= 0:
            raise ValueError(f"non-positive freq at {i}: symbol out of window")
        if state >= (f << 40):
            words.append(state & _MASK32)
            state >>= 32
        state = ((state // f) << PRECISION_BITS) + (state % f) + c
    return state, words


def rans_decode_np(
    state: int,
    words: Sequence[int],
    n: int,
    means: np.ndarray,
    scales: np.ndarray,
    cdf_eval=None,
) -> Tuple[int, np.ndarray]:
    """Decode ``n`` symbols. ``means``/``scales`` must be in *decode* order,
    i.e. reversed relative to encode order; ``words`` are consumed newest
    first (the caller passes the emission list; we pop from its tail).

    Returns (final_state, values in decode order).
    """
    means = np.asarray(means, np.float32)
    scales = np.asarray(scales, np.float32)
    cdf_eval = cdf_eval or cdf_bits_np
    lower = lower_bin_np(means).astype(np.int64)
    out = np.empty(n, np.int32)
    pos = len(words)
    for i in range(n):
        if state < RANS_L:
            pos -= 1
            state = (state << 32) | int(words[pos])
        mod = state & _MASK24
        lo = int(lower[i])
        hi = lo + NBINS - 1
        m = np.float32(means[i])
        s = np.float32(scales[i])
        lf = np.int32(lo)
        while lo <= hi:
            mid = (lo + hi) >> 1
            c = int(cdf_eval(np.int32(mid), m, s, lf))
            if c > mod:
                hi = mid - 1
            else:
                lo = mid + 1
        v = lo
        c_lo = int(cdf_eval(np.int32(v - 1), m, s, lf))
        c_hi = int(cdf_eval(np.int32(v), m, s, lf))
        f = c_hi - c_lo
        state = (state >> PRECISION_BITS) * f + mod - c_lo
        out[i] = v
    return state, out


def roundtrip_np(values, means, scales) -> bool:
    """Encode then decode; True iff bit-exact and state returns to RANS_L."""
    state, words = rans_encode_np(RANS_L, values, means, scales)
    n = len(values)
    st2, dec = rans_decode_np(
        state, words, n, np.asarray(means)[::-1], np.asarray(scales)[::-1]
    )
    return st2 == RANS_L and bool(
        np.all(dec[::-1] == np.asarray(values, np.int32)))
