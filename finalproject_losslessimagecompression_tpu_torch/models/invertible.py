"""Invertible flow components (PyTorch; public tensors are NHWC).

- Channel permutations are derived deterministically from
  (perm_seed, level, step) with numpy's SeedSequence, exactly as in the JAX
  package, and applied as a channel gather; the inverse is the argsort.
- AdditiveCoupling: za = xa, zb = xb + round(t(xa)).  Inputs and the rounded
  shift both live on the 2^-nbits grid, and float32 holds grid sums exactly,
  so forward and inverse are bit-exact inverses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops.rounding import round_ste
from .config import CouplingCfg, DenseBlockCfg
from .layers import DenseBlock


def permutation(seed: int, level: int, step: int, dim: int) -> np.ndarray:
    """Deterministic channel permutation for flow step `step` of `level`."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, level, step, dim])
    )
    return rng.permutation(dim).astype(np.int32)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    return np.argsort(perm).astype(np.int32)


def coupling_split(channel: int, split: float) -> Tuple[int, int]:
    """[a_ch, b_ch] channel split of a coupling."""
    a = int(channel * split)
    return a, channel - a


class AdditiveCoupling(nn.Module):
    """za = xa, zb = xb + round_ste(NN(xa)); exactly invertible on the grid."""

    def __init__(self, channel: int, cfg: CouplingCfg,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.a_ch, b_ch = coupling_split(channel, cfg.split)
        self.nbits = cfg.nbits
        self.dense = DenseBlock(self.a_ch, b_ch, cfg.nn, gen)

    def t(self, xa: torch.Tensor) -> torch.Tensor:
        """The rounded coupling shift of NHWC `xa`: the one function both
        directions of the codec evaluate."""
        return round_ste(self.dense.nhwc(xa), self.nbits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xa, xb = x[..., : self.a_ch], x[..., self.a_ch:]
        return torch.cat([xa, xb + self.t(xa)], dim=-1)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        za, zb = z[..., : self.a_ch], z[..., self.a_ch:]
        return torch.cat([za, zb - self.t(za)], dim=-1)


class Prior(nn.Module):
    """NN head mapping its prepared NHWC input to (mean, logscale) of the
    factored-out channels.  `logscale_min` floors the logscale, which keeps
    the scale well above the 1/256 grid."""

    def __init__(self, in_ch: int, out_ch: int, cfg: DenseBlockCfg,
                 logscale_min: float = -6.24,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.out_ch = out_ch
        self.logscale_min = logscale_min
        self.net = DenseBlock(in_ch, 2 * out_ch, cfg, gen)

    def forward(self, h: torch.Tensor):
        p = self.net.nhwc(h)
        mean = p[..., : self.out_ch]
        logscale = torch.clamp(p[..., self.out_ch:], min=self.logscale_min)
        return mean, logscale
