"""Frozen plain reader of the LIC2 containers the codec under test writes.

A copy, made when the benchmark was defined, of the container format and
the interleaved-rANS decode as the published format fixes them: the
header, the state chain that codes streams 1..S-1 into stream 0 with
uniform bit chunks, the bits-back hole (a container's first D words are
the final low limbs of the streams they seeded), the out-of-window escape
block, and the M = 2^24 quantized discretized-logistic CDF evaluated by
one explicit float32 op sequence.  It reads a container with given
priors; it is plain PyTorch and imports nothing of the package under
test, so a later change to that package cannot change how the benchmark
reads its output.

Symbol i goes to stream i % S; a state is two 32-bit limbs (hi, lo) in
int64 tensors; each step pops words for the streams whose hi limb is 0,
in ascending stream order, off the tail of the one word buffer.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np
import torch

MAGIC = b"LIC2"
HEADER = struct.Struct("<4sQIQII")
RANS_L = 1 << 32
M32 = (1 << 32) - 1
MASK24 = (1 << 24) - 1
NBINS = 2048
GRID = 256
PMAX = float((1 << 24) - NBINS)
PAD_MEAN, PAD_SCALE = 0.0, 1e-6
STEP_QUANTUM = 16


def plan_steps(n: int, S: int) -> int:
    k = -(-n // S)
    return -(-k // STEP_QUANTUM) * STEP_QUANTUM


def pick_num_streams(n: int, requested: int, sym_per_stream: int) -> int:
    return int(min(requested, max(8, n // sym_per_stream)))


def _pop(state: int, words: list, bits: int) -> Tuple[int, int]:
    if state < RANS_L:
        state = (state << 32) | words.pop()
    return state >> bits, state & ((1 << bits) - 1)


def chain_unpack(S: int, state0: int, words: list) -> List[int]:
    states = [0] * S
    for j in range(S - 1, 0, -1):
        state0, nb33 = _pop(state0, words, 5)
        nb = nb33 + 33
        top = 0
        if nb > 33:
            state0, top = _pop(state0, words, nb - 33)
        state0, c1 = _pop(state0, words, 16)
        state0, c0 = _pop(state0, words, 16)
        states[j] = (1 << (nb - 1)) | (top << 32) | (c1 << 16) | c0
    states[0] = state0
    return states


class Container:
    """An unpacked container: word buffer (with its bits-back hole still
    zero), word count, final states, escapes."""

    def __init__(self, blob: bytes):
        magic, n, S, state0, W, D = HEADER.unpack_from(blob, 0)
        if magic != MAGIC:
            raise ValueError("not a LIC2 container")
        present = W - min(D, W)
        payload = np.frombuffer(blob, "<u4", offset=HEADER.size,
                                count=present)
        words = np.zeros(W, np.int64)
        words[W - present:] = payload
        off = HEADER.size + 4 * present
        (m,) = struct.unpack_from("<I", blob, off)
        off += 4
        self.oow_idx = np.frombuffer(blob, "<u4", offset=off,
                                     count=m).astype(np.int64)
        self.oow_vals = np.frombuffer(blob, "<i4", offset=off + 4 * m,
                                      count=m).astype(np.int64)
        if m:
            (crc,) = struct.unpack_from("<I", blob, off + 8 * m)
            if crc != zlib.crc32(blob[off:off + 8 * m]):
                raise ValueError("escape block checksum")
        wl = [int(v) for v in words]
        states = chain_unpack(S, state0, wl)
        npay = len(wl)
        k = plan_steps(n, S)
        self.n, self.S, self.k = int(n), int(S), k
        self.buf = np.zeros(k * S, np.int64)
        self.buf[:npay] = words[:npay]
        self.num_words = npay
        self.donated = int(min(D, W))
        st = np.array(states, dtype=np.uint64)
        self.hi = (st >> np.uint64(32)).astype(np.int64)
        self.lo = (st & np.uint64(M32)).astype(np.int64)


def lower_bin(mean: torch.Tensor) -> torch.Tensor:
    return torch.round(mean * float(GRID)).to(torch.int32) - NBINS // 2


def cdf_bits(v, mean, scale, lower):
    """CDF(v) in [0, 2^24], one float32 op a line."""
    vf = v.to(torch.float32) * (1.0 / GRID)
    t = (vf + 0.5 / GRID - mean) / scale
    sig = torch.reciprocal(1.0 + torch.exp(-t))
    part1 = torch.round(sig * PMAX).to(torch.int32)
    return (part1 + (v - lower + 1)).to(torch.int64)


def _search(mod, m, s, lower):
    a = lower - 1
    c_a = cdf_bits(a, m, s, lower)
    span = NBINS
    while span > 1:
        span //= 2
        p = a + span
        cd = cdf_bits(p, m, s, lower)
        le = cd <= mod
        a = torch.where(le, p, a)
        c_a = torch.where(le, cd, c_a)
    v = a + 1
    return v, c_a, cdf_bits(v, m, s, lower)


def _layout(x: torch.Tensor, n: int, S: int, k: int, pad: float):
    flat = x.reshape(-1)
    if S * k > n:
        flat = torch.cat([flat, flat.new_full((S * k - n,), pad)])
    return flat.reshape(k, S)


def decode(c: Container, mean, logscale, fill=None, tail_start: int = 0):
    """Decode a container with its priors (float32, encode order, on one
    device).  fill: the final lo limbs that restore its bits-back hole.
    Returns (bins int64 [n], state invariant holds, final lo limbs)."""
    dev = mean.device
    m = _layout(mean.to(torch.float32), c.n, c.S, c.k, PAD_MEAN)
    s = _layout(torch.exp(logscale.to(torch.float32)), c.n, c.S, c.k,
                PAD_SCALE)
    lower = lower_bin(m)
    buf = torch.as_tensor(c.buf, device=dev)
    if fill is not None and c.donated:
        take = min(c.donated, fill.shape[0])
        buf[:take] = fill[:take]
    hi = torch.as_tensor(c.hi, device=dev)
    lo = torch.as_tensor(c.lo, device=dev)
    ptr = torch.tensor(c.num_words, dtype=torch.int64, device=dev)
    nbuf = buf.shape[0]
    vals = torch.empty((c.k, c.S), dtype=torch.int64, device=dev)
    for t in range(c.k - 1, -1, -1):
        need = hi == 0
        need_i = need.to(torch.int64)
        rank = torch.cumsum(need_i, 0) - need_i
        cnt = need_i.sum()
        idx = ptr - cnt + rank
        ok = need & (idx >= 0) & (idx < nbuf)
        word = torch.where(ok, buf[idx.clamp(0, nbuf - 1)],
                           torch.zeros_like(lo))
        hi = torch.where(need, lo, hi)
        lo = torch.where(need, word, lo)
        ptr = ptr - cnt
        mod = lo & MASK24
        v, c_lo, c_hi = _search(mod, m[t], s[t], lower[t])
        f = c_hi - c_lo
        tt = (hi << 8) | (lo >> 24)
        a_hi = (tt >> 24) * f
        low = ((a_hi & 0xFF) << 24) + (tt & MASK24) * f + (mod - c_lo)
        lo = low & M32
        hi = ((a_hi >> 8) + (low >> 32)) & M32
        vals[t] = v.to(torch.int64)
    bins = vals.reshape(-1)[:c.n].clone()
    if len(c.oow_idx):
        bins[torch.as_tensor(c.oow_idx, device=dev)] = torch.as_tensor(
            c.oow_vals, device=dev)
    idx = torch.arange(c.S, device=dev)
    ok = bool(torch.all(hi == 1)) and bool(
        torch.all((idx < tail_start) | (lo == 0)))
    return bins, ok, lo


def decode_chain(blobs, priors):
    """Decode one batch's per-level containers (level 0 first in `blobs`)
    given each level's (mean, logscale) in encode order: the levels are
    read from the last down, each restoring its hole from the level above
    it.  Returns ([bins per level], all state invariants hold)."""
    conts = [Container(b) for b in blobs]
    L = len(conts)
    out, ok_all, prev_lo = [None] * L, True, None
    for level in range(L - 1, -1, -1):
        c = conts[level]
        mean, logscale = priors[level]
        tail = 0 if level == 0 else conts[level - 1].donated
        bins, ok, lo = decode(c, mean, logscale,
                              None if level == L - 1 else prev_lo, tail)
        out[level], prev_lo = bins, lo
        ok_all = ok_all and ok
    return out, ok_all
