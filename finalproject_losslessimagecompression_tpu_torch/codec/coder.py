"""High-level latent coder: (latents, means, logscales) <-> bytes.

Each split level is one interleaved-rANS container; symbols are the integer
grid bins v = round(latent * 256), flattened in NHWC order.  Tensors stay on
their device; only the packed byte containers cross to the host.  The
`*_many` forms code several containers at once, one kernel launch for
those of the same stream layout.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .container import pack_streams, unpack_streams
from .interleaved import (
    interleaved_decode_many,
    interleaved_encode_many,
    upload,
)


def encode_tensors_deferred(items, num_streams: int = 8192, seeds=None,
                            sym_per_stream: int = 64):
    """Start the encode of several (latent, mean, logscale) tensors, one
    container each, without any host sync; seeds is a list of per-tensor
    seeds (or None).  Pack later with container.pack_streams_many."""
    flat = [(torch.round(z.to(torch.float32) * 256.0).to(torch.int32)
             .reshape(-1), mean.reshape(-1),
             torch.exp(logscale.to(torch.float32)).reshape(-1))
            for z, mean, logscale in items]
    return interleaved_encode_many(flat, seeds, num_streams, sym_per_stream)


def encode_tensor_deferred(latent, mean, logscale, num_streams: int = 8192,
                           seeds=None, sym_per_stream: int = 64):
    """Start an encode without any host sync; pack later with
    container.pack_streams_many."""
    return encode_tensors_deferred([(latent, mean, logscale)], num_streams,
                                   [seeds], sym_per_stream)[0]


def encode_tensor(latent, mean, logscale, num_streams: int = 8192) -> bytes:
    """Encode one latent tensor (values on the 1/256 grid) to bytes."""
    return pack_streams(
        encode_tensor_deferred(latent, mean, logscale, num_streams)
    )


def decode_many_deferred(encs, means, logscales, fills=None,
                         tail_starts=None):
    """Decode several containers without a host sync.

    Returns one (x, ok, lo) per container: decoded grid values shaped like
    its `mean`, the state-invariant flag (0-d bool tensor) and the final lo
    limbs.  For bits-back chains the lo limbs of a seeded decode are the
    donor container's omitted words: pass them as the donor's fill, and
    pass the donor's donated count as this decode's tail start so the
    check skips the seeded prefix.  Counts, tail starts and escapes may be
    device tensors (a container's padded form), so that the whole decode
    reads no host value."""
    for enc, mean in zip(encs, means):
        if enc.n != mean.numel():
            raise ValueError(
                f"container symbol count {enc.n} does not match the "
                f"parameter tensor size {mean.numel()}"
            )
    tail_starts = tail_starts or [0] * len(encs)
    scales = [torch.exp(ls.to(torch.float32)).reshape(-1) for ls in logscales]
    decoded = interleaved_decode_many(
        encs, [m.reshape(-1) for m in means], scales, fills)
    out = []
    for enc, mean, tail_start, (vals, hi, lo) in zip(encs, means,
                                                     tail_starts, decoded):
        if enc.oow_idx is not None:
            vals = patch_escapes(vals, enc.oow_idx, enc.oow_vals)
        x = (vals.to(torch.float32) / 256.0).reshape(mean.shape)
        out.append((x, states_ok(hi, lo, tail_start), lo))
    return out


def patch_escapes(vals: torch.Tensor, idx, true_vals) -> torch.Tensor:
    """The decoded bins [n] with the escaped out-of-window symbols' true
    values scattered in.  An index equal to n writes to a dump slot past
    the end, so a pair padded to a fixed length patches any count up to it
    without a host branch."""
    dev = vals.device
    out = torch.cat([vals, vals.new_zeros(1)])
    out.scatter_(0, torch.as_tensor(idx, dtype=torch.int64, device=dev),
                 torch.as_tensor(true_vals, device=dev).to(vals.dtype))
    return out[:-1]


def states_ok(hi: torch.Tensor, lo: torch.Tensor, tail_start=0):
    """The state invariant of a decode (0-d bool tensor): a successful
    decode returns each stream to 2^32 | seed, so hi == 1, and lo == 0 for
    every stream from `tail_start` on (an int or a 0-d tensor): a seeded
    level's lo limbs below it are its donor's words, checked by the chain's
    last, unseeded level."""
    idx = torch.arange(lo.shape[0], device=lo.device)
    return torch.all(hi == 1) & torch.all((idx < tail_start) | (lo == 0))


def decode_streams_deferred(enc, mean, logscale, fill=None, tail_start=0):
    """Decode one container without a host sync (see
    `decode_many_deferred`): returns (x, ok, lo)."""
    return decode_many_deferred([enc], [mean], [logscale], [fill],
                                [tail_start])[0]


def decode_tensor_deferred(blob: bytes, mean, logscale):
    """Decode without a host sync: returns (x, ok)."""
    x, ok, _ = decode_streams_deferred(
        upload([unpack_streams(blob)], mean.device)[0], mean, logscale)
    return x, ok


def decode_tensor(blob: bytes, mean, logscale):
    """Decode one latent tensor; returns float32 grid values, mean's shape.
    Raises ValueError if any stream fails to return to its initial state."""
    x, ok = decode_tensor_deferred(blob, mean, logscale)
    if not bool(ok):
        raise ValueError("rANS decode failed: state did not return to 2^32")
    return x


def encode_latents(latents: Sequence, means: Sequence, logscales: Sequence,
                   num_streams: int = 8192) -> List[bytes]:
    """Encode per-split latents, one container each."""
    return [
        encode_tensor(z, m, ls, num_streams)
        for z, m, ls in zip(latents, means, logscales)
    ]


def decode_latents(blobs: Sequence[bytes], means: Sequence,
                   logscales: Sequence):
    """Decode per-split latents given regenerated means/logscales."""
    return [
        decode_tensor(b, m, ls) for b, m, ls in zip(blobs, means, logscales)
    ]


def coded_bits(blobs: Sequence[bytes]) -> int:
    return sum(8 * len(b) for b in blobs)


def real_bpd(blobs: Sequence[bytes], num_pixels: int) -> float:
    """Coded bits per (pixel-channel) dim, including container overhead."""
    return coded_bits(blobs) / float(num_pixels)
