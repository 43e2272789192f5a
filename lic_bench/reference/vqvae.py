"""Plain float32 VQ-VAE of the published residual codec
(configs/resflow-cond-imagenet64.yaml, `vqvae`), over a weight dict named
as the package's state_dict names it.  Imports nothing of the package
under test.

Encoder: per hidden dim a 4x4 stride-2 conv and LeakyReLU, a 3x3 conv and
LeakyReLU, `block_num` ResBlocks (3x3 conv, ReLU, 3x3 conv, ReLU after the
residual add), a 1x1 conv to `embed_dim`, tanh.  Quantizer: the nearest
codeword by squared distance, the first index on ties.  Decoder: a 1x1
conv and LeakyReLU, the ResBlocks, a 3x3 conv and LeakyReLU, per reversed
hidden dim a 4x4 stride-2 transposed conv (LeakyReLU between, tanh
last).  The codec conditions on round((decode(codebook[idx]) + 1) / 2)
on the 1/256 grid.  `precision="tf32"` as in `flow.py`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .flow import LEAKY_SLOPE, tf32_mode, to_tf32


def shapes(vq: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every weight of the published VQ-VAE, named as the package's
    state_dict (no batch norm)."""
    out: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
    hd, C, D = list(vq["hidden_dims"]), vq["channel"], vq["embed_dim"]
    nb = vq["encoder"]["block_num"]

    def conv(name, cin, cout, k, transpose=False):
        out[name + ".weight"] = (cin, cout, k, k) if transpose else \
            (cout, cin, k, k)
        out[name + ".bias"] = (cout,)

    def blocks(prefix, ch, n):
        for j in range(n):
            conv(f"{prefix}.blocks.{j}.conv_a", ch, ch, 3)
            conv(f"{prefix}.blocks.{j}.conv_b", ch, ch, 3)

    ch = C
    for i, d in enumerate(hd):
        conv(f"encoder.convs.{i}", ch, d, 4)
        ch = d
    conv(f"encoder.convs.{len(hd)}", ch, ch, 3)
    conv(f"encoder.convs.{len(hd) + 1}", ch, D, 1)
    blocks("encoder", ch, nb)
    rev = hd[::-1]
    conv("decoder.convs.0", D, rev[0], 1)
    conv("decoder.convs.1", rev[0], rev[0], 3)
    blocks("decoder", rev[0], vq["decoder"]["block_num"])
    ch = rev[0]
    for i, d in enumerate(rev[1:] + [C]):
        conv(f"decoder.deconvs.{i}", ch, d, 4, transpose=True)
        ch = d
    out["vq.codebook"] = (vq["embed_num"], D)
    return out


class VQVAE:
    def __init__(self, vq: dict, weights: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        self.cfg, self.w = vq, weights
        dev = next(iter(weights.values())).device
        self.card_tf32 = precision == "tf32" and dev.type == "cuda"
        self.emulate = precision == "tf32" and dev.type != "cuda"

    def _conv(self, name, x, transpose=False, **kw):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if self.emulate:
            x, w = to_tf32(x), to_tf32(w)
        fn = F.conv_transpose2d if transpose else F.conv2d
        return fn(x, w, b, **kw)

    def _blocks(self, prefix, x, n):
        for j in range(n):
            h = F.relu(self._conv(f"{prefix}.blocks.{j}.conv_a", x,
                                  padding=1))
            h = self._conv(f"{prefix}.blocks.{j}.conv_b", h, padding=1)
            x = F.relu(x + h)
        return x

    def indices(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] images on the grid -> [B, h, w] codeword indices."""
        with tf32_mode(self.card_tf32), torch.no_grad():
            n = len(self.cfg["hidden_dims"])
            h = ((x - 0.5) / 0.5).permute(0, 3, 1, 2)
            for i in range(n):
                h = F.leaky_relu(self._conv(f"encoder.convs.{i}", h,
                                            stride=2, padding=1), LEAKY_SLOPE)
            h = F.leaky_relu(self._conv(f"encoder.convs.{n}", h, padding=1),
                             LEAKY_SLOPE)
            h = self._blocks("encoder", h, self.cfg["encoder"]["block_num"])
            h = torch.tanh(self._conv(f"encoder.convs.{n + 1}", h))
            b, d, hh, ww = h.shape
            flat = h.permute(0, 2, 3, 1).reshape(-1, d)
            cb = self.w["vq.codebook"]
            if self.emulate:
                flat, cb = to_tf32(flat), to_tf32(cb)
            dist = ((flat * flat).sum(1, keepdim=True) + (cb * cb).sum(1)
                    - 2.0 * flat @ cb.t())
            return torch.argmin(dist, dim=1).reshape(b, hh, ww)

    def reconstruction(self, idx: torch.Tensor, nbits: int = 8):
        """The conditioning image of [B, h, w] indices, on the grid."""
        with tf32_mode(self.card_tf32), torch.no_grad():
            h = self.w["vq.codebook"][idx.to(torch.int64)].permute(0, 3, 1, 2)
            h = F.leaky_relu(self._conv("decoder.convs.0", h), LEAKY_SLOPE)
            h = self._blocks("decoder", h, self.cfg["decoder"]["block_num"])
            h = F.leaky_relu(self._conv("decoder.convs.1", h, padding=1),
                             LEAKY_SLOPE)
            n = len(self.cfg["hidden_dims"])
            for i in range(n):
                h = self._conv(f"decoder.deconvs.{i}", h, transpose=True,
                               stride=2, padding=1)
                h = torch.tanh(h) if i == n - 1 else F.leaky_relu(
                    h, LEAKY_SLOPE)
            rec = h.permute(0, 2, 3, 1) * 0.5 + 0.5
            bins = float(2 ** nbits)
            return torch.round(rec * bins) / bins


def unpack_indices(blob: bytes):
    """The codec's bit-packed index stream (`VQIX`, B, h, w, K, then
    ceil(log2 K) bits an index, little-endian bit order) -> [B, h, w]."""
    import struct

    import numpy as np

    if blob[:4] != b"VQIX":
        raise ValueError("not a VQIX index stream")
    b, h, w, K = struct.unpack("<IIII", blob[4:20])
    bits = max(1, int(np.ceil(np.log2(max(K, 2)))))
    buf = np.frombuffer(blob, np.uint8, offset=20)
    pos = np.arange(b * h * w, dtype=np.int64) * bits
    flat = np.zeros(b * h * w, np.int64)
    for j in range(bits):
        p = pos + j
        flat |= ((buf[p >> 3] >> (p & 7).astype(np.uint8)) & 1).astype(
            np.int64) << j
    return flat.reshape(b, h, w)
