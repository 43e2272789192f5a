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
wrappers there run `encode_plain` / `decode_plain` / `cdf_prepass_plain`
below only for tensors that lie on the CPU.  `guided_search` and
`recip_divmod` are plain models of the kernels' symbol search and 64-bit
division, held by the tests against `_search` and exact integer division.

`interleaved_encode_many` / `interleaved_decode_many` code several
containers at once: those of one (S, k) go through one kernel launch.
`EncodedStreams.padded` lays an unpacked container out at a length fixed
by its plan and its escape slots, with its counts as values; `upload`
sends containers to the device in that form, so a decode reads no host
value and can be captured once per plan (models/exact.py's fused
granularity).
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
    arrays and the counts are ints; `upload` puts them on the device in
    the padded form (`padded`, `from_padded`), every count a 0-d tensor."""

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
    # container (absent from the packed payload; see models/exact.py); an
    # int, or a 0-d tensor in the padded form
    donated: object = 0

    def padded(self, max_outliers: int) -> np.ndarray:
        """The unpacked form as one int64 host vector whose length depends
        only on (n, S, max_outliers): the static input of a decode captured
        once for all containers of that plan (`from_padded` reads it back).
        Layout: words [k * S], hi [S], lo [S], num_words, donated,
        oow_count, then the escapes' indices padded with n (a dump slot
        past the last symbol) and their values padded with 0, each
        [max_outliers].  Raises ValueError past max_outliers escapes."""
        S = self.num_streams
        cap = _plan_steps(self.n, S) * S
        m = int(self.oow_count)
        if m > max_outliers:
            raise ValueError(f"{m} out-of-window escapes, at most "
                             f"{max_outliers} fit the padded form")
        if len(self.words) != cap:
            raise ValueError(f"word buffer of {len(self.words)}, the plan's "
                             f"capacity is {cap}")
        out = np.zeros(padded_size(self.n, S, max_outliers), np.int64)
        out[:cap] = self.words
        out[cap : cap + S] = self.state_hi
        out[cap + S : cap + 2 * S] = self.state_lo
        out[cap + 2 * S : cap + 2 * S + 3] = (self.num_words, self.donated, m)
        pos = cap + 2 * S + 3
        out[pos : pos + max_outliers] = self.n
        if m:
            out[pos : pos + m] = self.oow_idx
            out[pos + max_outliers : pos + max_outliers + m] = self.oow_vals
        return out

    @classmethod
    def from_padded(cls, flat: torch.Tensor, n: int, S: int,
                    max_outliers: int) -> "EncodedStreams":
        """Views of a `padded` vector (on any device) as a container whose
        counts are 0-d tensors, so that its decode reads no host value."""
        cap = _plan_steps(n, S) * S
        pos = cap + 2 * S + 3
        return cls(
            words=flat[:cap], num_words=flat[cap + 2 * S],
            state_hi=flat[cap : cap + S], state_lo=flat[cap + S : cap + 2 * S],
            n=n, num_streams=S, oow_count=flat[cap + 2 * S + 2],
            oow_idx=flat[pos : pos + max_outliers],
            oow_vals=flat[pos + max_outliers : pos + 2 * max_outliers],
            donated=flat[cap + 2 * S + 1],
        )


def padded_size(n: int, S: int, max_outliers: int) -> int:
    """Length of `EncodedStreams.padded`'s vector."""
    return _plan_steps(n, S) * S + 2 * S + 3 + 2 * max_outliers


def pad_many(encs, max_outliers: int = 0):
    """Unpacked containers' padded forms, each with max(max_outliers, its
    own escape count) escape slots, in one host int64 tensor, and their
    layouts [(n, S, slots)] for `from_padded_many`."""
    slots = [max(max_outliers, int(e.oow_count)) for e in encs]
    host = torch.from_numpy(np.concatenate(
        [e.padded(m) for e, m in zip(encs, slots)]))
    return host, [(e.n, e.num_streams, m) for e, m in zip(encs, slots)]


def from_padded_many(flat: torch.Tensor, layouts):
    """The containers of a `pad_many` vector (on any device), as views."""
    out, pos = [], 0
    for n, S, m in layouts:
        size = padded_size(n, S, m)
        out.append(EncodedStreams.from_padded(flat[pos:pos + size], n, S, m))
        pos += size
    return out


def to_device(host: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`: on the card in one copy from pinned
    memory that does not block the host, so that a decode can queue every
    container before its one sync."""
    device = torch.device(device)
    if device.type == "cuda" and host.device.type == "cpu":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def upload(encs, device, max_outliers: int = 0):
    """Unpacked containers on `device` in their padded form, in one copy:
    the one layout every decode of packed containers takes."""
    host, layouts = pad_many(encs, max_outliers)
    return from_padded_many(to_device(host, device), layouts)


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


def cdf_prepass_plain(v, m, s, lower):
    """Plain version of the prepass kernel: per symbol one 16-byte record,
    as int64 [..., 2]: the float64 bits of 1 / freq, then
    c_start | freq << 32."""
    c_start, freq = cdf_tiles(v, m, s, lower)
    recip = (1.0 / freq.to(torch.float64)).view(torch.int64)
    return torch.stack([recip, c_start | (freq << 32)], dim=-1)


def unpack_prepass(rec):
    """(c_start int64, freq int64, recip float64) of prepass records."""
    return (rec[..., 1] & M32, rec[..., 1] >> 32,
            rec[..., 0].contiguous().view(torch.float64))


def recip_divmod(x: int, f: int):
    """(x // f, x % f) as the encode kernel computes them, for
    x < f * 2^40 and 1 <= f < 2^24: the float64 product x * (1 / f)
    (each operation correctly rounded) is off from x / f by less than one,
    so its truncation is corrected by one integer step."""
    q = int(float(x) * (1.0 / f))
    r = x - q * f
    if r < 0:
        q, r = q - 1, r + f
    elif r >= f:
        q, r = q + 1, r - f
    return q, r


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
    """Plain version of the encode kernels (prepass and state chain):
    [k, S] window-clamped bins, means, scales and window lower bounds ->
    (words [k, S] int64, flags [k, S] int32, hi [S] int64, lo [S] int64)."""
    c_start, freq = cdf_tiles(v, m, s, lower)
    words, flags, hi, lo = encode_state_loop(c_start, freq, seeds)
    return words, flags.to(torch.int32), hi, lo


def _prepare_encode(values, means, scales, S: int, k: int):
    """Layout [n] -> [k, S] and the out-of-window escape: the bins clamped
    into the codable window (the true values of clamped symbols travel in
    the container side channel).  Returns (v_clamped, m, s, lower,
    oow_count, oow, v_orig)."""
    n = values.numel()
    v = _layout(values.to(torch.int32), n, S, k, PAD_VALUE)
    m = _layout(means.to(torch.float32), n, S, k, PAD_MEAN)
    s = _layout(scales.to(torch.float32), n, S, k, PAD_SCALE)
    lower = lower_bin(m)
    v_clamped = torch.minimum(torch.maximum(v, lower), lower + (NBINS - 1))
    oow = (v_clamped != v).reshape(-1)
    return v_clamped, m, s, lower, oow.sum(), oow, v.reshape(-1)


def compact(words: torch.Tensor, flags: torch.Tensor):
    """The emitted words of [..., k, S] tiles as one contiguous buffer per
    container in (t, s) order: (buf [..., k*S] int64, zero past the end;
    total [...]).  Emitted word (t, s) of container c goes to c * k*S plus
    the number of emissions before it in c; the rest go to a dump slot past
    the last container."""
    lead = words.shape[:-2]
    cap = words.shape[-2] * words.shape[-1]
    flags = flags.reshape(-1, cap).to(torch.int64)
    C = flags.shape[0]
    pos = torch.cumsum(flags, 1) - 1 + cap * torch.arange(
        C, device=words.device)[:, None]
    pos = torch.where(flags != 0, pos, torch.full_like(pos, C * cap))
    buf = torch.zeros(C * cap + 1, dtype=torch.int64, device=words.device)
    buf.scatter_(0, pos.reshape(-1), words.reshape(-1))
    return buf[:-1].reshape(*lead, cap), flags.sum(1).reshape(lead)


def _groups(keys):
    """Indices grouped by key, in first-seen order."""
    out = {}
    for i, key in enumerate(keys):
        out.setdefault(key, []).append(i)
    return out.values()


def interleaved_encode_many(items, seeds=None, num_streams: int = 8192,
                            sym_per_stream: int = 64):
    """Encode several messages, one container each: items are (values,
    means, scales) flat [n] on one device, seeds a list of per-message
    seeds (or None).  Messages of the same (S, k) are encoded by one
    launch of each encode kernel.  Returns a list of EncodedStreams, equal
    to encoding each message alone."""
    from .cuda_rans import rans_encode

    seeds = seeds or [None] * len(items)
    plans, prepared = [], []
    for values, means, scales in items:
        n = values.numel()
        S = pick_num_streams(n, num_streams, sym_per_stream)
        plans.append((n, S, _plan_steps(n, S)))
        prepared.append(_prepare_encode(values, means, scales, S,
                                        plans[-1][2]))
    out = [None] * len(items)
    keys = [(S, k, sd is None) for (_, S, k), sd in zip(plans, seeds)]
    for idx in _groups(keys):
        stack = [torch.stack([prepared[i][j] for i in idx]) for j in range(4)]
        sd = None if seeds[idx[0]] is None else torch.stack(
            [seeds[i].to(torch.int64).reshape(-1) for i in idx])
        words, flags, hi, lo = rans_encode(*stack, sd)
        buf, total = compact(words, flags)
        for c, i in enumerate(idx):
            n, S, _ = plans[i]
            _, _, _, _, oow_count, oow, v_orig = prepared[i]
            out[i] = EncodedStreams(
                words=buf[c], num_words=total[c], state_hi=hi[c],
                state_lo=lo[c], n=n, num_streams=S, oow_count=oow_count,
                oow_mask=oow, orig_values=v_orig,
            )
    return out


def interleaved_encode(values, means, scales, num_streams: int = 8192,
                       seeds=None, sym_per_stream: int = 64) -> EncodedStreams:
    """Encode integer-bin symbols (v = round(x*256)) with S parallel streams.
    values: int [n]; means, scales: float32 [n], all on one device."""
    return interleaved_encode_many([(values, means, scales)], [seeds],
                                   num_streams, sym_per_stream)[0]


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


_PMAX = float((1 << 24) - NBINS)


def guess_bin(mod, m, s, lower):
    """The decode kernel's hint for the smallest v with CDF(v) > mod:
    256 * (mean + scale * logit(p)) - 1/2 with
    p = (mod + 1/2 - (v - lower + 1)) / (2^24 - 2048), the linear term
    taken at the window's centre and then at the first guess, clamped to
    the window and to [lower + mod - (2^24 - 2048), lower + mod], where the
    answer must lie because the sigmoid term of CDF is in [0, 2^24 - 2048].
    float32 throughout (the kernel takes logf fast: the guess is only a
    hint, so the two need not agree)."""
    u = mod.to(torch.float32) + 0.5
    centre = 256.0 * m - lower.to(torch.float32)
    lin = torch.full_like(u, 1025.0)
    for _ in range(2):
        p = ((u - lin) * (1.0 / _PMAX)).clamp(2.0 ** -40, 1.0 - 2.0 ** -24)
        d = centre + 256.0 * s * (torch.log(p) - torch.log(1.0 - p)) - 0.5
        d = torch.nan_to_num(d, nan=-1.0).clamp(-1.0, float(NBINS - 1))
        lin = torch.floor(d) + 2.0
    off = torch.floor(d).to(torch.int64) + 1
    off = torch.maximum(torch.minimum(off, mod.clamp(max=NBINS - 1)),
                        (mod - int(_PMAX)).clamp(min=0))
    return lower + off.to(torch.int32)


def bracket_search(mod, m, s, lower, g):
    """The decode kernel's search from a guess g in [lower, lower + 2047]:
    CDF(g - 1) and CDF(g) verify the bracket.  On a miss, CDF's rise of at
    least one per bin bounds the answer within mod - CDF(g) + 1 bins above
    g (or CDF(g - 1) - mod below g - 1); one round evaluates the next bin
    past the bracket and the pair at that bound, then bisection closes the
    rest.  lo keeps "lo == lower - 1 or CDF(lo) <= mod", hi keeps
    "hi == lower + 2047 or CDF(hi) > mod".  Returns (v, CDF(v - 1), CDF(v)),
    equal to `_search` for every mod and every guess."""
    top, bot = lower + (NBINS - 1), lower - 1
    cdf = lambda v: cdf_bits(v, m, s, lower)  # noqa: E731
    ca, cb = cdf(g - 1), cdf(g)
    up = (g != top) & (cb <= mod)  # the answer lies above g
    down = ~up & (g != lower) & (ca > mod)  # ... below g
    # the round after a miss: the next bin, the bound, and the bin inside it
    near = torch.where(up, g + 1, g - 2)
    far = torch.where(
        up, g + torch.minimum((top - g).to(torch.int64), mod - cb + 1),
        g - 1 - torch.minimum((g - 1 - bot).to(torch.int64), ca - mod),
    ).to(torch.int32)
    inner = torch.where(up, far - 1, far + 1)
    cn, cf, ci = cdf(near), cdf(far), cdf(inner)
    closed_up = up & ((near == top) | (cn > mod))
    closed_down = down & ((near == bot) | (cn <= mod))
    open_up, open_down = up & ~closed_up, down & ~closed_down
    # hit, or a miss closed by the next bin
    lo = torch.where(up, g, torch.where(closed_down, g - 2, g - 1))
    clo = torch.where(up, cb, torch.where(closed_down, cn, ca))
    hi = torch.where(up, g + 1, torch.where(down, g - 1, g))
    chi = torch.where(up, cn, torch.where(down, ca, cb))
    # still open: the next bin joins the known side, the bound the other
    lo = torch.where(open_up, near, torch.where(open_down, far, lo))
    clo = torch.where(open_up, cn, torch.where(open_down, cf, clo))
    hi = torch.where(open_up, far, torch.where(open_down, near, hi))
    chi = torch.where(open_up, cf, torch.where(open_down, cn, chi))
    inside = (open_up | open_down) & (inner > lo) & (inner < hi)
    to_hi, to_lo = inside & (ci > mod), inside & (ci <= mod)
    hi, chi = torch.where(to_hi, inner, hi), torch.where(to_hi, ci, chi)
    lo, clo = torch.where(to_lo, inner, lo), torch.where(to_lo, ci, clo)
    while bool((hi - lo > 1).any()):
        act = hi - lo > 1
        p = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        cp = cdf(p)
        to_hi = act & (cp > mod)
        to_lo = act & ~(cp > mod)
        hi, chi = torch.where(to_hi, p, hi), torch.where(to_hi, cp, chi)
        lo, clo = torch.where(to_lo, p, lo), torch.where(to_lo, cp, clo)
    return hi, clo, chi


def guided_search(mod, m, s, lower):
    """Plain model of the decode kernel's symbol search: `bracket_search`
    from `guess_bin`."""
    return bracket_search(mod, m, s, lower, guess_bin(mod, m, s, lower))


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


def fill_hole(buf: torch.Tensor, fill: torch.Tensor, donated) -> None:
    """Bits-back hole restore, in place: a container omits its first
    `donated` words, which are the final lo limbs `fill` of the streams
    they seeded.  `donated` is an int or a 0-d tensor on buf's device, so
    the restore needs no host value."""
    take = min(fill.shape[0], buf.shape[0])
    hole = torch.arange(take, device=buf.device) < donated
    buf[:take] = torch.where(hole, fill[:take], buf[:take])


def interleaved_decode_many(encs, means, scales, fills=None):
    """Decode several containers given the means/scales used at encode time
    (flat [n] each, encode order, on the coding device).  fills: per
    container, the final lo limbs that restore its bits-back hole (or
    None; `fill_hole`, so its donated count may be a device value).
    Containers of the same (S, k) are decoded by one kernel launch.
    Returns a list of (values int32 [n], hi, lo); a successful decode
    returns every stream to 2^32 | seed."""
    from .cuda_rans import rans_decode

    fills = fills or [None] * len(encs)
    dev = means[0].device
    keys = [(e.num_streams, _plan_steps(e.n, e.num_streams)) for e in encs]
    out = [None] * len(encs)
    for idx in _groups(keys):
        S, k = keys[idx[0]]
        col = lambda f: torch.stack([  # noqa: E731
            torch.as_tensor(f(encs[i]), dtype=torch.int64, device=dev)
            for i in idx])
        buf = col(lambda e: e.words)
        for c, i in enumerate(idx):
            if fills[i] is not None:
                fill_hole(buf[c], fills[i], encs[i].donated)
        m = torch.stack([_layout(means[i].to(torch.float32), encs[i].n, S,
                                 k, PAD_MEAN) for i in idx])
        s = torch.stack([_layout(scales[i].to(torch.float32), encs[i].n, S,
                                 k, PAD_SCALE) for i in idx])
        vals, hi, lo = rans_decode(
            buf, col(lambda e: e.num_words).reshape(-1), col(
                lambda e: e.state_hi), col(lambda e: e.state_lo), m, s,
            lower_bin(m))
        for c, i in enumerate(idx):
            out[i] = (vals[c].reshape(-1)[:encs[i].n], hi[c], lo[c])
    return out


def interleaved_decode(enc: EncodedStreams, means, scales, fill=None):
    """Decode one container (see `interleaved_decode_many`).  Returns
    (values int32 [n], hi, lo)."""
    return interleaved_decode_many([enc], [means], [scales], [fill])[0]
