"""Quantized CDF, interleaved rANS (plain coder + Hopper kernels), LIC2
containers, the latent coder and the single-stream oracle."""

from .cdf import (
    GRID,
    GRID_BITS,
    NBINS,
    PRECISION,
    PRECISION_BITS,
    cdf_bits,
    cdf_bits_np,
    lower_bin,
    symbol_freq_np,
)
from .coder import (
    coded_bits,
    decode_latents,
    decode_tensor,
    encode_latents,
    encode_tensor,
    real_bpd,
)
from .container import (
    pack_streams,
    pack_streams_many,
    stream_bits,
    unpack_streams,
)
from .interleaved import (
    EncodedStreams,
    interleaved_decode,
    interleaved_encode,
    pick_num_streams,
)
from .oracle import RANS_L, rans_decode_np, rans_encode_np, roundtrip_np

__all__ = [
    "GRID",
    "GRID_BITS",
    "NBINS",
    "PRECISION",
    "PRECISION_BITS",
    "cdf_bits",
    "cdf_bits_np",
    "lower_bin",
    "symbol_freq_np",
    "RANS_L",
    "rans_encode_np",
    "rans_decode_np",
    "roundtrip_np",
    "coded_bits",
    "decode_latents",
    "decode_tensor",
    "encode_latents",
    "encode_tensor",
    "real_bpd",
    "pack_streams",
    "pack_streams_many",
    "stream_bits",
    "unpack_streams",
    "EncodedStreams",
    "interleaved_decode",
    "interleaved_encode",
    "pick_num_streams",
]
