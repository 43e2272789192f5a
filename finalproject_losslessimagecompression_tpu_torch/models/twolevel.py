"""Two-level coarse/fine pyramid flow.

Pipeline: replication-pad the image by `pad` -> adaptive-average-pool it to
the rough flow's size -> round to the grid -> rough IDFlow on the pooled
image; fine residual = padded image - upsampled rough image -> tiles of the
fine flow's size -> fine IDFlow over every tile of the batch.

Pooling follows torch's AdaptiveAvgPool windows [floor(i * In / Out),
ceil((i + 1) * In / Out)) and is applied as two averaging matrices
(`adaptive_pool_matrix`, the JAX package's, bit for bit) by einsum; the
upsampling `unpool` is the same construction with the roles swapped.  When
the padded size is a multiple of the rough size, every upsampling row is
one-hot, so unpool is a replication and exact on the 1/256 grid.

In training the fine flow, which sees B x tiles patches, runs under
`torch.utils.checkpoint` (its activations are recomputed in the backward
pass), as the JAX package rematerialises it.  The model lives on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.reshape import patch_merge, patch_split
from ..ops.rounding import round_to_grid
from .config import FlowCfg, latent_shapes
from .idflow import IDFlow, resolve_device


@dataclass(frozen=True)
class TwoLevelCfg:
    H: int
    W: int
    C: int
    pad: Tuple[int, int]
    rough: FlowCfg
    fine: FlowCfg
    nbits: int = 8

    @property
    def Hp(self) -> int:  # padded dims
        return self.H + self.pad[0]

    @property
    def Wp(self) -> int:
        return self.W + self.pad[1]

    @classmethod
    def from_ref(cls, cfg: dict) -> "TwoLevelCfg":
        cfg = dict(cfg)
        cfg.pop("name", None)
        cfg.pop("batchsize", None)
        return cls(
            H=cfg.pop("H"),
            W=cfg.pop("W"),
            C=cfg.pop("C", 3),
            pad=tuple(cfg.pop("pad", (0, 0))),
            rough=FlowCfg.from_ref(dict(cfg.pop("rough_flows"))),
            fine=FlowCfg.from_ref(dict(cfg.pop("fine_flows"))),
            nbits=cfg.pop("nbits", 8),
        )


def adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] row-stochastic matrix of torch's AdaptiveAvgPool1d
    windows."""
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        s = (i * n_in) // n_out
        e = -(-(i + 1) * n_in // n_out)
        m[i, s:e] = 1.0 / (e - s)
    return m


def pool2d(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor):
    """NHWC x -> mh . x . mw^T over the two spatial axes."""
    return torch.einsum("bhwc,Hh,Ww->bHWc", x, mh, mw)


def pad_edge(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replication padding of an NHWC batch at the bottom and right."""
    if not ph and not pw:
        return x
    h, w = x.shape[1], x.shape[2]
    ih = torch.arange(h + ph, device=x.device).clamp_(max=h - 1)
    iw = torch.arange(w + pw, device=x.device).clamp_(max=w - 1)
    return x.index_select(1, ih).index_select(2, iw)


class TwoLevelFlow(nn.Module):
    """`rough` and `fine` IDFlows (weights drawn from `seed` and `seed + 1`;
    load trained or converted weights with `load_state_dict`)."""

    def __init__(self, cfg: TwoLevelCfg, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.rough = IDFlow(cfg.rough, device=device, seed=seed)
        self.fine = IDFlow(cfg.fine, device=device, seed=seed + 1)
        for name, (n_in, n_out) in (("pool_h", (cfg.Hp, cfg.rough.H)),
                                    ("pool_w", (cfg.Wp, cfg.rough.W)),
                                    ("up_h", (cfg.rough.H, cfg.Hp)),
                                    ("up_w", (cfg.rough.W, cfg.Wp))):
            self.register_buffer(name, torch.from_numpy(
                adaptive_pool_matrix(n_in, n_out)).to(device),
                persistent=False)

    @property
    def device(self) -> torch.device:
        return self.rough.device

    @property
    def latent_shapes(self):
        """[rough z0 shape, fine z0 shape with the tile count folded into
        the channels]."""
        c = self.cfg
        r = latent_shapes(c.rough)[0]
        f = latent_shapes(c.fine)[0]
        tiles = (c.Hp // c.fine.H) * (c.Wp // c.fine.W)
        return [r, (f[0], f[1], f[2] * tiles)]

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        return pool2d(x, self.pool_h, self.pool_w)

    def unpool(self, rx: torch.Tensor) -> torch.Tensor:
        return pool2d(rx, self.up_h, self.up_w)

    def split_levels(self, x: torch.Tensor):
        """-> (rough image rx, fine patch batch px)."""
        c = self.cfg
        x = pad_edge(x, *c.pad)
        rx = round_to_grid(self.pool(x), c.nbits)
        px = patch_split(x - self.unpool(rx), c.fine.H, c.fine.W)
        return rx, px

    def forward(self, x: torch.Tensor):
        """-> ((rough latents, means, logscales), (fine latents, means,
        logscales)); under autograd the fine flow's activations are
        recomputed in the backward pass."""
        rx, px = self.split_levels(x)
        rough_out = self.rough(rx)
        if torch.is_grad_enabled():
            # the fine flow draws no random numbers, and reading the card's
            # RNG state is not allowed while a train step is captured
            fine_out = checkpoint(self.fine, px, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            fine_out = self.fine(px)
        return rough_out, fine_out

    def sample_from_noise(self, noises):
        """noises = [rough noise [B, rh, rw, zc], fine noise with the tiles
        folded into the channels]."""
        c = self.cfg
        rx = self.rough.sample_from_noise([noises[0]])
        f = latent_shapes(c.fine)[0]
        fx = self.fine.sample_from_noise([noises[1].reshape(-1, *f)])
        x = self.unpool(rx) + patch_merge(fx, c.Hp, c.Wp)
        return x[:, :c.H, :c.W, :]


def twolevel_bpd(cfg: TwoLevelCfg, bpd_rough: float, bpd_fine: float):
    """Bits per dimension of an image from the two levels' bpd."""
    rough = bpd_rough * cfg.rough.H * cfg.rough.W
    return (rough + bpd_fine * cfg.Hp * cfg.Wp) / cfg.H / cfg.W
