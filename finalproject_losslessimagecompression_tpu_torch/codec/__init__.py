"""Quantized CDF, interleaved rANS (plain coder + Hopper kernels), LIC2
containers and the latent coder."""

from .cdf import GRID, NBINS, PRECISION, cdf_bits, lower_bin
from .coder import (
    coded_bits,
    decode_latents,
    decode_tensor,
    encode_latents,
    encode_tensor,
    real_bpd,
)
from .container import pack_streams, pack_streams_many, unpack_streams
from .interleaved import (
    EncodedStreams,
    interleaved_decode,
    interleaved_encode,
    pick_num_streams,
)

__all__ = [
    "GRID",
    "NBINS",
    "PRECISION",
    "cdf_bits",
    "lower_bin",
    "coded_bits",
    "decode_latents",
    "decode_tensor",
    "encode_latents",
    "encode_tensor",
    "real_bpd",
    "pack_streams",
    "pack_streams_many",
    "unpack_streams",
    "EncodedStreams",
    "interleaved_decode",
    "interleaved_encode",
    "pick_num_streams",
]
