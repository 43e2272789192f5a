"""Bitstream container: serialize interleaved-rANS streams to bytes (LIC2).

The final states of streams 1..S-1 are coded into stream 0 as uniform bit
chunks (a uniform symbol is coded by pure shifts at zero redundancy), so the
container stores only stream 0's final 64-bit state.  The layout is the JAX
package's, byte for byte (little-endian):

    magic  b"LIC2"        4 bytes
    n      symbols        8 bytes
    S      streams        4 bytes
    state0                8 bytes
    W      word count     4 bytes  (original count, including donated)
    D      donated count  4 bytes  (bits-back: the first D words are not
                                    stored; the decoder recovers them from
                                    the final states of the streams they
                                    seeded -- see models/exact.py)
    words  (W - min(D, W)) * 4 bytes   (positions D..W-1 of the global
                                        (t, s) emission order + chain words)
    oow_count             4 bytes
    oow_idx, oow_vals     8 * oow_count bytes (raw out-of-window escapes)
    oow_crc32             4 bytes, present iff oow_count > 0

The state chain runs in C++ (csrc/chain.cpp, built with g++ at first use
and bound with ctypes); `chain_pack_py` / `chain_unpack_py` are its plain
Python form, which the tests hold it against.
"""

from __future__ import annotations

import ctypes
import math
import os
import struct
import threading
import zlib
from typing import List, Tuple

import numpy as np
import torch

from .cdf import NBINS, PRECISION
from .interleaved import EncodedStreams, _plan_steps
from .native import CSRC_DIR, build_native

MAGIC = b"LIC2"
_HEADER = struct.Struct("<4sQIQII")
RANS_L = 1 << 32
# the cheapest codable symbol costs -log2((M - 2047) / M) bits; it bounds a
# container's plausible symbol count by its payload's information capacity
_MIN_SYMBOL_BITS = -math.log2(float(PRECISION - (NBINS - 1)) / PRECISION)

_CHAIN_SRC = os.path.join(CSRC_DIR, "chain.cpp")
_chain_lock = threading.Lock()
_chain_lib = None


# ---------------------------------------------------------------------------
# state chain
# ---------------------------------------------------------------------------


def _chain():
    """Build (once per source hash) and bind csrc/chain.cpp; raises if the
    build fails."""
    global _chain_lib
    with _chain_lock:
        if _chain_lib is not None:
            return _chain_lib
        lib = ctypes.CDLL(build_native(
            _CHAIN_SRC, "g++", ["-O3", "-fPIC", "-shared", "-std=c++17"],
            "chain"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.chain_pack.restype = i
        lib.chain_pack.argtypes = [i, p, p, i, i, p]
        lib.chain_unpack.restype = i
        lib.chain_unpack.argtypes = [i, ctypes.c_uint64, p, i, p]
        _chain_lib = lib
        return lib


def chain_pack(states: np.ndarray, words: np.ndarray, num_words: int):
    """Chain final states 1..S-1 into state0 plus words appended after
    words[:num_words].  `words` (uint32) needs 5 * S + 8 spare words and is
    modified in place.  Returns (state0, new word count)."""
    st = np.ascontiguousarray(states, np.uint64)
    if words.dtype != np.uint32 or not words.flags.c_contiguous:
        raise TypeError("chain_pack: words must be contiguous uint32")
    out = ctypes.c_uint64(0)
    nw = _chain().chain_pack(
        st.shape[0], st.ctypes.data, words.ctypes.data, num_words,
        words.shape[0], ctypes.addressof(out),
    )
    if nw < 0:
        raise ValueError("chain pack overflow")
    return int(out.value), nw


def chain_unpack(S: int, state0: int, words: np.ndarray, num_words: int):
    """Inverse of chain_pack: (states uint64 [S], payload word count).
    Raises ValueError on underflow (corrupt container)."""
    w = np.ascontiguousarray(words, np.uint32)
    if num_words > w.shape[0]:
        raise ValueError("corrupt container: word count exceeds payload")
    states = np.empty(S, np.uint64)
    nw = _chain().chain_unpack(S, state0, w.ctypes.data, num_words,
                               states.ctypes.data)
    if nw < 0:
        raise ValueError("corrupt container: state chain underflow")
    return states, nw


def _uniform_push(state: int, words: list, chunk: int, bits: int) -> int:
    """Push `bits` uniform bits (zero-redundancy rANS op: shift-or)."""
    if state >= (1 << (64 - bits)):
        words.append(state & 0xFFFFFFFF)
        state >>= 32
    return ((state << bits) | chunk) & ((1 << 64) - 1)


def _uniform_pop(state: int, words: list, bits: int) -> Tuple[int, int]:
    if state < RANS_L:
        state = (state << 32) | words.pop()
    return state >> bits, state & ((1 << bits) - 1)


def chain_pack_py(states, words: list) -> int:
    """Plain Python form of chain_pack: appends to `words`, returns state0."""
    states = [int(s) for s in states]
    state0 = states[0]
    for sj in states[1:]:
        nb = sj.bit_length()  # in [33, 64]
        top = nb - 33  # bits above the low 32, minus the implicit lead 1
        state0 = _uniform_push(state0, words, sj & 0xFFFF, 16)
        state0 = _uniform_push(state0, words, (sj >> 16) & 0xFFFF, 16)
        if top > 0:
            state0 = _uniform_push(
                state0, words, (sj >> 32) & ((1 << top) - 1), top
            )
        state0 = _uniform_push(state0, words, nb - 33, 5)
    return state0


def chain_unpack_py(S: int, state0: int, words: list) -> List[int]:
    """Plain Python form of chain_unpack: pops from `words`, returns the S
    states."""
    states = [0] * S
    try:
        for j in range(S - 1, 0, -1):
            state0, nb33 = _uniform_pop(state0, words, 5)
            nb = nb33 + 33
            top = 0
            if nb > 33:
                state0, top = _uniform_pop(state0, words, nb - 33)
            state0, c1 = _uniform_pop(state0, words, 16)
            state0, c0 = _uniform_pop(state0, words, 16)
            states[j] = (1 << (nb - 1)) | (top << 32) | (c1 << 16) | c0
    except IndexError:
        raise ValueError("corrupt container: state chain underflow") from None
    states[0] = state0
    return states


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------


def pack_streams_many(encs) -> list:
    """Serialize several encodes with one device-to-host copy: every
    container's states, counts and full word buffer are concatenated on the
    device and fetched together.  Only containers with out-of-window
    escapes (rare) pay one more fetch for their side channel."""
    parts = []
    for e in encs:
        dev = e.words.device
        parts += [
            e.state_hi, e.state_lo,
            torch.as_tensor(e.num_words, device=dev).reshape(1),
            torch.as_tensor(e.oow_count, device=dev).reshape(1),
            e.words,
        ]
    flat = torch.cat([p.to(torch.int64).reshape(-1) for p in parts])
    flat = flat.cpu().numpy()
    out, pos = [], 0
    for e in encs:
        S, cap = e.num_streams, e.words.shape[0]
        hi = flat[pos : pos + S]
        lo = flat[pos + S : pos + 2 * S]
        nw, oc = int(flat[pos + 2 * S]), int(flat[pos + 2 * S + 1])
        words = flat[pos + 2 * S + 2 : pos + 2 * S + 2 + cap]
        pos += 2 * S + 2 + cap
        oow = b""
        if oc:
            mask = e.oow_mask.cpu().numpy()
            idx = np.nonzero(mask)[0]
            vals = e.orig_values.cpu().numpy()[idx]
            oow = (np.asarray(idx, "<u4").tobytes()
                   + np.asarray(vals, "<i4").tobytes())
        out.append(_pack_fetched(e, hi, lo, words, nw, oc, oow))
    return out


def pack_streams(enc: EncodedStreams) -> bytes:
    """Serialize encoded streams to a self-contained byte string."""
    return pack_streams_many([enc])[0]


def _pack_fetched(enc, hi_a, lo_a, words_a, num_words: int,
                  oow_count: int = 0, oow_blob: bytes = b"") -> bytes:
    S = enc.num_streams
    states = (np.asarray(hi_a, np.uint64) << np.uint64(32)) | np.asarray(
        lo_a, np.uint64)
    # donated words are a prefix of the symbol payload (never the chain
    # words appended after it), so clamp to num_words before the pack
    donated = min(int(enc.donated or 0), num_words)
    buf = np.empty(num_words + 5 * S + 8, np.uint32)
    buf[:num_words] = np.asarray(words_a[:num_words]).astype(np.uint32)
    state0, nw = chain_pack(states, buf, num_words)
    out = bytearray(_HEADER.pack(MAGIC, enc.n, S, state0, nw, donated))
    out += buf[donated:nw].astype("<u4").tobytes()
    out += struct.pack("<I", oow_count)
    out += oow_blob
    if oow_count:
        # the escape block is outside the rANS state invariant, so it
        # carries its own checksum
        out += struct.pack("<I", zlib.crc32(oow_blob))
    return bytes(out)


def unpack_streams(blob: bytes) -> EncodedStreams:
    """Parse a container into host-side streams ready for decode.

    Every header field is validated against the blob's actual size before
    any allocation, so corrupt or truncated containers raise ValueError."""
    if len(blob) < _HEADER.size + 4:
        raise ValueError("corrupt container: truncated header")
    magic, n, S, state0, W, D = _HEADER.unpack_from(blob, 0)
    if magic != MAGIC:
        raise ValueError("bad container magic")
    avail_words = (len(blob) - _HEADER.size - 4) // 4
    present = W - min(D, W)
    if present > avail_words:
        raise ValueError("corrupt container: word count exceeds payload")
    if not (1 <= S <= max(8, n)):
        raise ValueError("corrupt container: implausible stream count")
    # n bounds the decode-side allocation: reject symbol counts beyond the
    # payload's information capacity (+64 bytes of header/state slack)
    if float(n) * _MIN_SYMBOL_BITS > 8.0 * (len(blob) + 64):
        raise ValueError("corrupt container: implausible symbol count")
    payload = np.frombuffer(blob, dtype="<u4", offset=_HEADER.size,
                            count=present)
    # bits-back hole: the first min(D, W) words were donated as seeds; the
    # caller fills them back in before decoding this container
    words_np = np.zeros(W, np.uint32)
    words_np[W - present:] = payload
    off = _HEADER.size + 4 * present
    (oow_count,) = struct.unpack_from("<I", blob, off)
    off += 4
    oow_idx = oow_vals = None
    if oow_count:
        if off + 8 * oow_count + 4 > len(blob):
            raise ValueError("corrupt container: outlier block truncated")
        oow_idx = np.frombuffer(blob, "<u4", offset=off,
                                count=oow_count).astype(np.int64)
        off += 4 * oow_count
        oow_vals = np.frombuffer(blob, "<i4", offset=off,
                                 count=oow_count).astype(np.int32)
        (crc,) = struct.unpack_from("<I", blob, off + 4 * oow_count)
        if crc != zlib.crc32(blob[off - 4 * oow_count : off + 4 * oow_count]):
            raise ValueError("corrupt container: outlier block checksum")
        if np.any(oow_idx >= n):
            raise ValueError("corrupt container: outlier index out of range")

    states, npay = chain_unpack(S, state0, words_np, W)
    k = _plan_steps(n, S)
    cap = k * S
    if npay > cap:
        raise ValueError("corrupt container: more words than stream capacity")
    if min(D, W) > npay:
        raise ValueError("corrupt container: donated hole exceeds payload")
    buf = np.zeros(cap, np.int64)
    buf[:npay] = words_np[:npay]
    return EncodedStreams(
        words=buf,
        num_words=npay,
        state_hi=(states >> np.uint64(32)).astype(np.int64),
        state_lo=(states & np.uint64(0xFFFFFFFF)).astype(np.int64),
        n=n,
        num_streams=S,
        oow_count=int(oow_count),
        oow_idx=oow_idx,
        oow_vals=oow_vals,
        donated=int(min(D, W)),
    )
