"""Quantized discretized-logistic CDF for the rANS coder (PyTorch).

Symbols live on the 1/256 grid; each symbol is the integer bin
v = round(x * 256), restricted to a 2048-bin window centred on the mean:
[lower, lower + 2047] with lower = rint(mean * 256) - 1024.  At precision
M = 2^24 the cumulative distribution is

    CDF(v) = rint(sigmoid((v/256 + 0.5/256 - mean)/scale) * (M - 2048))
           + (v - lower) + 1

so every bin has frequency >= 1, CDF(lower - 1) = 0 and
CDF(lower + 2047) = M.

`cdf_bits` uses the same explicit float32 op sequence as the JAX package's
`codec/cdf.py`, and the CUDA kernels (csrc/rans_kernels.cu) repeat it with
contraction disabled.  `exp` is not bit-equal across backends, so the coder
treats the evaluation backend as part of the stream contract: a container
decodes on the backend that encoded it.
"""

from __future__ import annotations

import torch

PRECISION_BITS = 24
PRECISION = 1 << PRECISION_BITS  # M = 2^24
NBINS = 2048
NBINS_LOG2 = 11
GRID_BITS = 8
GRID = 1 << GRID_BITS  # 256 bins per unit
# float32-exact constants (powers of two, and 2^24 - 2048 < 2^24)
_HALF_BIN = 0.5 / GRID
_INV_GRID = 1.0 / GRID
_PMAX = float(PRECISION - NBINS)


def lower_bin(mean: torch.Tensor) -> torch.Tensor:
    """Integer lower edge of the 2048-bin window: rint(mean*256) - 1024."""
    m = mean.to(torch.float32)
    return torch.round(m * float(GRID)).to(torch.int32) - (NBINS // 2)


def cdf_bits(v: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
             lower: torch.Tensor) -> torch.Tensor:
    """CDF(v) in [0, 2^24] as int64.  v, lower: int32 bins; mean, scale:
    float32.  Each line is one float32 op, in the reference's order."""
    vf = v.to(torch.float32) * _INV_GRID
    t = (vf + _HALF_BIN - mean) / scale
    sig = torch.reciprocal(1.0 + torch.exp(-t))
    part1 = torch.round(sig * _PMAX).to(torch.int32)
    part2 = v - lower + 1
    return (part1 + part2).to(torch.int64)
