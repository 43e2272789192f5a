"""VQ-VAE: encoder, vector quantizer, decoder (PyTorch; public tensors NHWC).

- VQEncoder: 4x4 stride-2 convs (one per hidden dim) with LeakyReLU, a 3x3
  conv, ResBlocks, a 1x1 conv to embed_dim, tanh.
- VectorQuantizer: nearest codeword by the x^2 + e^2 - 2xe expansion (one
  [N, D] x [D, K] matmul), argmin taking the first index on ties; the
  commitment / codebook losses with beta / gamma; straight-through
  estimator; per-codeword usage counts.
- VQDecoder: the mirror, with 4x4 stride-2 transposed convs.

flax's ConvTranspose (padding "SAME", no kernel flip) pads the dilated input
by (2, 2) and correlates it with its kernel; torch's conv_transpose2d with
padding 1 does the same with the kernel flipped in both spatial axes, so
`convert.vqvae_params_from_flax` flips the flax kernel when it loads it.

Dead-code reinitialisation is the pure function `vq_reinit`, as in the JAX
package.  Weights are drawn from a torch.Generator seeded with `seed`
(lecun-normal convs, zero biases, a uniform(-1, 1) codebook); load trained
or converted weights with `load_state_dict`.  The modules live on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import ENDECODERS
from .idflow import resolve_device
from .layers import BatchNorm, ResBlock, flax_conv


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class VectorQuantizer(nn.Module):
    def __init__(self, num: int = 4096, dim: int = 512,
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.num, self.dim = num, dim
        self.codebook = nn.Parameter(
            torch.rand((num, dim), generator=gen) * 2.0 - 1.0)

    def forward(self, x: torch.Tensor, beta: float = 0.25,
                gamma: float = 1.0):
        """x: [N, D] -> (vq_x [N, D], loss, idx [N] int64, counts [num])."""
        cb = self.codebook
        x2 = (x * x).sum(dim=1, keepdim=True)  # [N, 1]
        e2 = (cb * cb).sum(dim=1)  # [K]
        d = x2 + e2 - 2.0 * torch.matmul(x, cb.t())  # [N, K]
        idx = torch.argmin(d, dim=1)  # the first index on ties
        vq_x = cb[idx]
        loss = beta * torch.mean((x - vq_x.detach()) ** 2) + \
            gamma * torch.mean((x.detach() - vq_x) ** 2)
        vq_x = x + (vq_x - x).detach()
        # bincount's values without its host read of the largest index (a
        # sync, which a captured step may not make)
        counts = torch.zeros(self.num, dtype=torch.int64,
                             device=idx.device).index_add_(
            0, idx, torch.ones_like(idx)).to(torch.float32) \
            * (1.0 / idx.shape[0])
        return vq_x, loss, idx, counts


def vq_reinit(codebook: torch.Tensor, counts: torch.Tensor,
              batch_vectors: torch.Tensor, reinit_interval: float,
              threshold: float):
    """Pure dead-code reinit: when the accumulated counts exceed
    reinit_interval, codewords used less than reinit_interval / num *
    threshold are replaced by batch vectors (cycled in order) and the counts
    reset to zero.  Returns (new_codebook, new_counts, did_reinit,
    num_replaced), the last two as 0-d tensors."""
    num = codebook.shape[0]
    n = batch_vectors.shape[0]
    do = counts.sum() > reinit_interval
    low = counts < reinit_interval / num * min(threshold, 1.0)
    ranks = torch.cumsum(low.to(torch.int64), 0) - 1
    repl = batch_vectors[torch.remainder(ranks, n)]
    new_codebook = torch.where((do & low)[:, None], repl, codebook)
    new_counts = torch.where(do, torch.zeros_like(counts), counts)
    return new_codebook, new_counts, do, low.to(torch.int32).sum()


@ENDECODERS.register(name="VQEncoder")
class VQEncoder(nn.Module):
    """NHWC [B, H, W, C] -> [B, H / 2^len(hidden_dims), ..., out_channel].
    Sub-modules are listed in the flax module's creation order (`convs`:
    Conv_0.., `bns`: BatchNorm_0.., `blocks`: ResBlock_0..)."""

    def __init__(self, in_channel: int, out_channel: int,
                 hidden_dims: Tuple[int, ...] = (128, 256),
                 block_num: int = 2, batch_norm: bool = False,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.batch_norm = batch_norm
        convs, ch = [], in_channel
        for dim in hidden_dims:
            convs.append(flax_conv(ch, dim, 4, 2, 1, gen))
            ch = dim
        convs.append(flax_conv(ch, ch, 3, 1, 1, gen))
        convs.append(flax_conv(ch, out_channel, 1, gen=gen))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(
            BatchNorm(d) for d in (*hidden_dims, ch)) if batch_norm else None
        self.blocks = nn.ModuleList(
            ResBlock(ch, batch_norm, gen) for _ in range(block_num))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _nchw(x)
        for i, conv in enumerate(self.convs[:-1]):
            x = F.leaky_relu(conv(x))
            if self.batch_norm:
                x = self.bns[i](x, train)
        for block in self.blocks:
            x = block(x, train)
        return _nhwc(torch.tanh(self.convs[-1](x)))


@ENDECODERS.register(name="VQDecoder")
class VQDecoder(nn.Module):
    """NHWC latents -> NHWC images (x 2^len(hidden_dims)); `hidden_dims` is
    the encoder's reversed.  `convs`: Conv_0 (1x1), Conv_1 (3x3);
    `deconvs`: ConvTranspose_0..; `bns`: BatchNorm_0.. in creation order."""

    def __init__(self, in_channel: int, out_channel: int,
                 hidden_dims: Tuple[int, ...] = (256, 128),
                 block_num: int = 2, batch_norm: bool = False,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.batch_norm = batch_norm
        ch = hidden_dims[0]
        self.convs = nn.ModuleList([flax_conv(in_channel, ch, 1, gen=gen),
                                    flax_conv(ch, ch, 3, 1, 1, gen)])
        self.blocks = nn.ModuleList(
            ResBlock(ch, batch_norm, gen) for _ in range(block_num))
        deconvs = []
        for dim in (*hidden_dims[1:], out_channel):
            deconvs.append(flax_conv(ch, dim, 4, 2, 1, gen, transpose=True))
            ch = dim
        self.deconvs = nn.ModuleList(deconvs)
        self.bns = nn.ModuleList(
            BatchNorm(d) for d in hidden_dims) if batch_norm else None

    def _bn(self, i: int, x, train: bool):
        return self.bns[i](x, train) if self.batch_norm else x

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self._bn(0, F.leaky_relu(self.convs[0](_nchw(x))), train)
        for block in self.blocks:
            x = block(x, train)
        x = F.leaky_relu(self.convs[1](x))
        for i, deconv in enumerate(self.deconvs[:-1]):
            x = self._bn(i + 1, F.leaky_relu(deconv(x)), train)
        return _nhwc(torch.tanh(self.deconvs[-1](x)))


@ENDECODERS.register(name="VQVAE")
class VQVAE(nn.Module):
    def __init__(self, channel: int = 3, embed_num: int = 4096,
                 embed_dim: int = 512,
                 hidden_dims: Tuple[int, ...] = (128, 256),
                 block_num: int = 2, batch_norm: bool = False,
                 distribution: str = "BinomialDistribution",
                 device=None, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.channel, self.embed_num, self.embed_dim = (channel, embed_num,
                                                        embed_dim)
        self.distribution = distribution
        hidden_dims = tuple(hidden_dims)
        self.encoder = VQEncoder(channel, embed_dim, hidden_dims, block_num,
                                 batch_norm, gen)
        self.decoder = VQDecoder(embed_dim, channel, hidden_dims[::-1],
                                 block_num, batch_norm, gen)
        self.vq = VectorQuantizer(embed_num, embed_dim, gen)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.vq.codebook.device

    def encode(self, x, beta: float = 0.25, gamma: float = 1.0,
               train: bool = False):
        """-> (vq_x NHWC, loss, idx [N], counts, flat inputs [N, D])."""
        h = self.encoder(x, train)
        b, hh, ww, d = h.shape
        flat = h.reshape(-1, d)
        vq_x, loss, idx, counts = self.vq(flat, beta, gamma)
        return vq_x.reshape(b, hh, ww, d), loss, idx, counts, flat

    def decode(self, z, train: bool = False):
        return self.decoder(z, train)

    def forward(self, x, beta: float = 0.25, gamma: float = 1.0,
                train: bool = False):
        vq_x, loss, _, counts, flat = self.encode(x, beta, gamma, train)
        return self.decode(vq_x, train), loss, counts, flat

    def reconstruct(self, x):
        """Inference-only reconstruction."""
        return self.decode(self.encode(x)[0])


def build_vqvae_from_ref(cfg: dict, device=None, seed: int = 0) -> VQVAE:
    """Parse the reference YAML subtree (configs/vqvae_for_*.yaml)."""
    cfg = dict(cfg)
    cfg.pop("name", None)
    cfg.pop("checkpoint", None)
    enc = dict(cfg.pop("encoder", {}) or {})
    dec = dict(cfg.pop("decoder", {}) or {})
    dist = dict(cfg.pop("distribution", {}) or
                {"name": "BinomialDistribution"})
    block_num = enc.pop("block_num", dec.pop("block_num", 2))
    # batch_norm lives at the top level and/or inside the ResBlock subtree
    bn = cfg.pop("batch_norm", None)
    if bn is None:
        blk = dict(enc.get("block", {}) or {})
        blk_d = dict(dec.get("block", {}) or {})
        bn = blk.get("batch_norm", blk_d.get("batch_norm", False))
    return VQVAE(
        channel=cfg.pop("channel", 3),
        embed_num=cfg.pop("embed_num", 4096),
        embed_dim=cfg.pop("embed_dim", 512),
        hidden_dims=tuple(cfg.pop("hidden_dims", (128, 256))),
        block_num=block_num,
        batch_norm=bool(bn),
        distribution=dist.get("name", "BinomialDistribution"),
        device=device, seed=seed,
    )


def vqvae_reinit_params(cfg: dict) -> Tuple[float, float]:
    """(reinit_interval, threshold) from the reference YAML subtree."""
    vq = dict(dict(cfg).get("vectorquantizer", {}) or {})
    return vq.get("reinit_interval") or 0, vq.get("threshold") or 0.1
