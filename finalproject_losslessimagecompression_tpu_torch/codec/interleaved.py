"""Interleaved rANS: S streams advanced in lockstep (plain PyTorch coder).

Symbol i goes to stream i % S; step t advances every stream by one symbol.
Per-stream semantics are those of the JAX package's `codec/interleaved.py`:
state interval [2^32, 2^64), 32-bit word renormalisation, the M = 2^24
quantized-logistic CDF (codec/cdf.py), and one global word buffer in
(step, stream) emission order, so a container needs no per-stream counts or
offsets: the decoder re-derives each step's refill set from its own states,
ranks the refilling streams by index, and pops that many words off the tail.

This module is the plain version of the coder.  It keeps each 64-bit state
as two 32-bit limbs (hi, lo) in int64 tensors, because CPU PyTorch lacks
most uint32 ops and a full state can exceed 2^63.  Word buffers, limbs and
seeds are int64 tensors holding values in [0, 2^32).  The CUDA kernels that
replace the two state loops on the card are in codec/cuda_rans.py; the
wrappers there run `encode_plain` / `decode_plain` below only for
tensors that lie on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .cdf import NBINS, cdf_bits, lower_bin

M32 = (1 << 32) - 1
MASK24 = (1 << 24) - 1
PAD_MEAN = 0.0
PAD_SCALE = 1e-6  # near-delta: padding symbols cost ~0.0002 bits
PAD_VALUE = 0
STEP_QUANTUM = 16  # scan lengths are bucketed to multiples of this


@dataclass
class EncodedStreams:
    """Result of an interleaved encode (before container pack).

    On the encode side every field is a tensor on the coding device, so an
    encode needs no host sync; container packing fetches them in one copy.
    On the unpacked side `words`, `state_hi` and `state_lo` are host numpy
    arrays and the counts are ints."""

    words: object  # [cap] int64, global emission buffer, (t, s) order
    num_words: object  # int or 0-d int64 tensor: words used (prefix)
    state_hi: object  # [S] int64 final states, high limbs
    state_lo: object  # [S] int64, low limbs
    n: int  # number of real (unpadded) symbols
    num_streams: int
    # out-of-window escape: values beyond mean +- 4 are clamped into the
    # 2048-bin window for coding and their true values ride in the
    # container's side channel
    oow_count: object = 0  # int or 0-d tensor
    oow_mask: Optional[torch.Tensor] = None  # [k*S] bool (padded layout)
    orig_values: Optional[torch.Tensor] = None  # [k*S] int32 (padded)
    oow_idx: Optional[np.ndarray] = None  # [m] flat symbol indices
    oow_vals: Optional[np.ndarray] = None  # [m] int32 true bin values
    # bits-back: number of leading words donated as seeds to another
    # container (absent from the packed payload; see models/exact.py)
    donated: int = 0

    def to(self, device) -> "EncodedStreams":
        """The unpacked form with its arrays on `device`, in one copy.  On
        the card the copy is from pinned memory and does not block the host,
        so a decode pipeline can queue every container before its one sync."""
        S, cap = self.num_streams, len(self.words)
        m = 0 if self.oow_idx is None else len(self.oow_idx)
        host = np.concatenate([
            np.asarray(self.words, np.int64),
            np.asarray(self.state_hi, np.int64),
            np.asarray(self.state_lo, np.int64),
            np.asarray([self.num_words], np.int64),
            np.asarray(self.oow_idx if m else [], np.int64),
            np.asarray(self.oow_vals if m else [], np.int64),
        ])
        flat = torch.from_numpy(host)
        device = torch.device(device)
        if device.type == "cuda":
            flat = flat.pin_memory().to(device, non_blocking=True)
        else:
            flat = flat.to(device)
        pos = cap + 2 * S + 1
        return EncodedStreams(
            words=flat[:cap], num_words=flat[cap + 2 * S],
            state_hi=flat[cap : cap + S], state_lo=flat[cap + S : cap + 2 * S],
            n=self.n, num_streams=S, oow_count=self.oow_count,
            oow_idx=flat[pos : pos + m] if m else None,
            oow_vals=flat[pos + m : pos + 2 * m].to(torch.int32) if m else None,
            donated=self.donated,
        )


def _layout(arr: torch.Tensor, n: int, S: int, k: int, pad_const) -> torch.Tensor:
    """Flat [n] -> [k, S] with tail padding."""
    flat = arr.reshape(-1)
    pad = S * k - n
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), pad_const)])
    return flat.reshape(k, S)


def _plan_steps(n: int, S: int) -> int:
    k = -(-n // S)
    return -(-k // STEP_QUANTUM) * STEP_QUANTUM


def pick_num_streams(n: int, requested: int = 8192,
                     sym_per_stream: int = 64) -> int:
    """Cap parallelism so each stream codes >= ~sym_per_stream symbols (each
    stream's flush costs a few bits, ~37 for an unseeded one)."""
    return int(min(requested, max(8, n // sym_per_stream)))


def make_seeds(words: torch.Tensor, num_words, S: int,
               offset: int = 0) -> torch.Tensor:
    """Bits-back seeds: words [offset, offset+S) of an encoded buffer,
    zero past num_words.  `num_words` may be a device scalar (no sync)."""
    end = min(offset + S, words.shape[0])
    take = max(end - offset, 0)
    w = torch.zeros(S, dtype=torch.int64, device=words.device)
    w[:take] = words[offset:end]
    idx = torch.arange(S, device=words.device) + offset
    return torch.where(idx < num_words, w, torch.zeros_like(w))


# ---------------------------------------------------------------------------
# Encode (plain version of the encode kernel)
# ---------------------------------------------------------------------------


def cdf_tiles(v, m, s, lower):
    """CDF prepass: (c_start, freq) int64 tiles of window-clamped bins."""
    c_start = cdf_bits(v - 1, m, s, lower)
    return c_start, cdf_bits(v, m, s, lower) - c_start


def encode_state_loop(c_start: torch.Tensor, freq: torch.Tensor,
                      seeds: Optional[torch.Tensor] = None):
    """Advance S streams over k steps of precomputed [k, S] int64
    (c_start, freq) tiles.  Returns (words [k, S] int64, flags [k, S] bool,
    hi [S], lo [S]).  Per step and stream: emit the low 32 bits when
    state >= f << 40, then state = (state // f) << 24 + state % f + c_start
    (exact in int64 limbs: state < f * 2^40 after renormalisation)."""
    k, S = c_start.shape
    hi = torch.ones(S, dtype=torch.int64, device=c_start.device)
    lo = (torch.zeros_like(hi) if seeds is None
          else seeds.to(torch.int64).reshape(S).clone())
    words = torch.empty((k, S), dtype=torch.int64, device=c_start.device)
    flags = torch.empty((k, S), dtype=torch.bool, device=c_start.device)
    for t in range(k):
        f = freq[t]
        emit = hi >= (f << 8)
        words[t] = torch.where(emit, lo, torch.zeros_like(lo))
        flags[t] = emit
        lo = torch.where(emit, hi, lo)
        hi = torch.where(emit, torch.zeros_like(hi), hi)
        # (hi * 2^32 + lo) divmod f, digit by digit: hi % f < 2^24, so the
        # second dividend is < 2^56
        q_hi = torch.div(hi, f, rounding_mode="floor")
        rest = ((hi - q_hi * f) << 32) | lo
        q_lo = torch.div(rest, f, rounding_mode="floor")
        r = rest - q_lo * f
        q = (q_hi << 32) + q_lo  # < 2^40
        low = ((q & 0xFF) << 24) + r + c_start[t]  # < 2^33
        lo = low & M32
        hi = (q >> 8) + (low >> 32)
    return words, flags, hi, lo


def encode_plain(v, m, s, lower, seeds=None):
    """Plain version of the encode kernel: [k, S] window-clamped bins,
    means, scales and window lower bounds -> (words [k, S] int64,
    flags [k, S] int32, hi [S] int64, lo [S] int64)."""
    c_start, freq = cdf_tiles(v, m, s, lower)
    words, flags, hi, lo = encode_state_loop(c_start, freq, seeds)
    return words, flags.to(torch.int32), hi, lo


def _encode_core(values, means, scales, num_streams: int, steps: int,
                 seeds=None):
    """Layout, window clamp, the state loop (kernel or plain, by device)
    and compaction of the emitted words in (t, s) order.  values, means,
    scales arrive flat [n] on one device; n <= steps * num_streams."""
    from .cuda_rans import rans_encode

    S, k = num_streams, steps
    n = values.numel()
    v = _layout(values.to(torch.int32), n, S, k, PAD_VALUE)
    m = _layout(means.to(torch.float32), n, S, k, PAD_MEAN)
    s = _layout(scales.to(torch.float32), n, S, k, PAD_SCALE)
    # out-of-window escape: clamp into the codable window; the true values
    # of clamped symbols travel in the container side channel
    lower = lower_bin(m)
    v_clamped = torch.minimum(torch.maximum(v, lower), lower + (NBINS - 1))
    oow = (v_clamped != v).reshape(-1)
    oow_count = oow.sum()

    words, flags, hi, lo = rans_encode(v_clamped, m, s, lower, seeds)
    buf, total = compact(words, flags)
    return buf, total, hi, lo, oow_count, oow, v.reshape(-1)


def compact(words: torch.Tensor, flags: torch.Tensor):
    """The emitted words of [k, S] tiles as one buffer in (t, s) order:
    (buf [k*S] int64, zero past the end; total, a 0-d tensor).  Emitted
    word (t, s) goes to the number of emissions before it; the rest go to a
    dump slot past the end."""
    cap = words.numel()
    flags = flags.reshape(-1).to(torch.int64)
    pos = torch.cumsum(flags, 0) - 1
    pos = torch.where(flags != 0, pos, torch.full_like(pos, cap))
    buf = torch.zeros(cap + 1, dtype=torch.int64, device=words.device)
    buf.scatter_(0, pos, words.reshape(-1))
    return buf[:cap], flags.sum()


def interleaved_encode(values, means, scales, num_streams: int = 8192,
                       seeds=None, sym_per_stream: int = 64) -> EncodedStreams:
    """Encode integer-bin symbols (v = round(x*256)) with S parallel streams.
    values: int [n]; means, scales: float32 [n], all on one device."""
    n = values.numel()
    S = pick_num_streams(n, num_streams, sym_per_stream)
    k = _plan_steps(n, S)
    buf, total, hi, lo, oow_count, oow, v_orig = _encode_core(
        values, means, scales, S, k, seeds
    )
    return EncodedStreams(
        words=buf, num_words=total, state_hi=hi, state_lo=lo, n=n,
        num_streams=S, oow_count=oow_count, oow_mask=oow,
        orig_values=v_orig,
    )


# ---------------------------------------------------------------------------
# Decode (plain version of the decode kernel)
# ---------------------------------------------------------------------------


def _search(mod, m, s, lower):
    """Smallest v with CDF(v) > mod, by a 13-evaluation bitwise binary
    search over the window.  Returns (v, CDF(v - 1), CDF(v))."""
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


def decode_step(hi, lo, ptr, buf, m, s, lower):
    """One decode step over all S streams.  Streams with hi == 0 pop, in
    ascending stream order, the last `cnt` words before `ptr` (an exclusive
    prefix sum ranks them); then the search finds the symbol and
    state = (state >> 24) * f + (state & 0xFFFFFF) - CDF(v - 1), mod 2^64.
    Returns (v, hi, lo, ptr)."""
    need = hi == 0
    need_i = need.to(torch.int64)
    rank = torch.cumsum(need_i, 0) - need_i
    cnt = need_i.sum()
    idx = ptr - cnt + rank
    nbuf = buf.shape[0]
    ok = need & (idx >= 0) & (idx < nbuf)
    word = torch.where(ok, buf[idx.clamp(0, nbuf - 1)], torch.zeros_like(lo))
    hi = torch.where(need, lo, hi)
    lo = torch.where(need, word, lo)
    ptr = ptr - cnt

    mod = lo & MASK24
    v, c_lo, c_hi = _search(mod, m, s, lower)
    f = c_hi - c_lo
    # (state >> 24) = hi * 2^8 + (lo >> 24) < 2^40; split it at bit 24 so
    # both partial products fit int64, then add mod - c_lo mod 2^64
    t = (hi << 8) | (lo >> 24)
    a_hi = (t >> 24) * f  # < 2^40
    low = ((a_hi & 0xFF) << 24) + (t & MASK24) * f + (mod - c_lo)
    lo = low & M32
    hi = ((a_hi >> 8) + (low >> 32)) & M32
    return v.to(torch.int32), hi, lo, ptr


def decode_plain(buf, num_words, hi, lo, m, s, lower):
    """Plain version of the decode kernel: walks the [k, S] tiles in
    reverse from ptr = num_words.  Returns (vals [k, S] int32, hi, lo)."""
    k, S = m.shape
    ptr = torch.as_tensor(num_words, dtype=torch.int64, device=buf.device)
    hi = hi.to(torch.int64)
    lo = lo.to(torch.int64)
    vals = torch.empty((k, S), dtype=torch.int32, device=buf.device)
    for t in range(k - 1, -1, -1):
        vals[t], hi, lo, ptr = decode_step(
            hi, lo, ptr, buf, m[t], s[t], lower[t]
        )
    return vals, hi, lo


def _decode_core(buf, num_words, hi, lo, means, scales, num_streams: int,
                 steps: int, fill=None, donated=0):
    """Layout, bits-back hole fill, and the decode loop (kernel or plain, by
    device).  Returns (values [n] int32, hi, lo)."""
    from .cuda_rans import rans_decode

    S, k = num_streams, steps
    n = means.numel()
    m = _layout(means.to(torch.float32), n, S, k, PAD_MEAN)
    s = _layout(scales.to(torch.float32), n, S, k, PAD_SCALE)
    if fill is not None:
        # bits-back hole restore: the container omitted its first `donated`
        # words; they are the final lo limbs of the streams they seeded
        take = min(int(fill.shape[0]), int(buf.shape[0]), int(donated))
        buf = buf.clone()
        buf[:take] = fill[:take]
    vals, hi, lo = rans_decode(buf, num_words, hi, lo, m, s, lower_bin(m))
    return vals.reshape(-1)[:n], hi, lo


def interleaved_decode(enc: EncodedStreams, means, scales, fill=None):
    """Decode all symbols given the means/scales used at encode time (flat
    [n], encode order, on the coding device).  Returns (values int32 [n],
    hi, lo); a successful decode returns every stream to 2^32 | seed."""
    dev = means.device
    S, n = enc.num_streams, enc.n
    return _decode_core(
        torch.as_tensor(enc.words, dtype=torch.int64, device=dev),
        torch.as_tensor(enc.num_words, dtype=torch.int64, device=dev),
        torch.as_tensor(enc.state_hi, dtype=torch.int64, device=dev),
        torch.as_tensor(enc.state_lo, dtype=torch.int64, device=dev),
        means, scales, S, _plan_steps(n, S), fill, enc.donated,
    )
