"""High-level latent coder: (latents, means, logscales) <-> bytes.

Each split level is one interleaved-rANS container; symbols are the integer
grid bins v = round(latent * 256), flattened in NHWC order.  Tensors stay on
their device; only the packed byte containers cross to the host.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .container import pack_streams, unpack_streams
from .interleaved import interleaved_decode, interleaved_encode


def encode_tensor_deferred(latent, mean, logscale, num_streams: int = 8192,
                           seeds=None, sym_per_stream: int = 64):
    """Start an encode without any host sync; pack later with
    container.pack_streams_many."""
    v = torch.round(latent.to(torch.float32) * 256.0).to(torch.int32)
    scale = torch.exp(logscale.to(torch.float32))
    return interleaved_encode(v.reshape(-1), mean.reshape(-1),
                              scale.reshape(-1), num_streams, seeds,
                              sym_per_stream)


def encode_tensor(latent, mean, logscale, num_streams: int = 8192) -> bytes:
    """Encode one latent tensor (values on the 1/256 grid) to bytes."""
    return pack_streams(
        encode_tensor_deferred(latent, mean, logscale, num_streams)
    )


def decode_streams_deferred(enc, mean, logscale, fill=None, tail_start=0):
    """Decode streams without a host sync.

    Returns (x, ok, lo): decoded grid values shaped like `mean`, the
    state-invariant flag (0-d bool tensor) and the final lo limbs.  For
    bits-back chains the lo limbs of a seeded decode are the donor
    container's omitted words: pass them as the donor's `fill`, and pass
    the donor's donated count as this decode's `tail_start` so the check
    skips the seeded prefix."""
    if enc.n != mean.numel():
        raise ValueError(
            f"container symbol count {enc.n} does not match the "
            f"parameter tensor size {mean.numel()}"
        )
    scale = torch.exp(logscale.to(torch.float32)).reshape(-1)
    vals, hi, lo = interleaved_decode(enc, mean.reshape(-1), scale, fill)
    if enc.oow_count:
        # patch escaped out-of-window symbols with their true values
        dev = vals.device
        vals = vals.clone()
        vals[torch.as_tensor(enc.oow_idx, dtype=torch.int64, device=dev)] = (
            torch.as_tensor(enc.oow_vals, dtype=torch.int32, device=dev))
    # a successful decode returns each stream to 2^32 | seed: hi == 1, and
    # lo == 0 for every stream past `tail_start` (seeded streams' lo limbs
    # are the donor's words, checked by the chain's last, unseeded level)
    idx = torch.arange(lo.shape[0], device=lo.device)
    ok = torch.all(hi == 1) & torch.all((idx < tail_start) | (lo == 0))
    x = (vals.to(torch.float32) / 256.0).reshape(mean.shape)
    return x, ok, lo


def decode_tensor_deferred(blob: bytes, mean, logscale):
    """Decode without a host sync: returns (x, ok)."""
    x, ok, _ = decode_streams_deferred(unpack_streams(blob), mean, logscale)
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
