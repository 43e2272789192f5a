"""Reconstruction likelihoods for the VQ-VAE.

- BinomialDistribution: the Binomial(255, y) log-likelihood of
  round(x * 255), the default VQ-VAE reconstruction loss.
- UnitGaussianDistribution: the N(y, 1) log-density of x.
"""

from __future__ import annotations

import math

import torch

from ..registry import DISTRIBUTIONS

_HALF_LOG_2PI = 0.9189385332046727
_LGAMMA_256 = math.lgamma(256.0)


@DISTRIBUTIONS.register(name="BinomialDistribution")
class BinomialDistribution:
    def log_prob(self, x: torch.Tensor, y: torch.Tensor, eps: float = 1e-6):
        k = torch.round(x * 255.0)
        y = torch.clamp(y, eps, 1.0 - eps)
        log_comb = (_LGAMMA_256 - torch.lgamma(k + 1.0)
                    - torch.lgamma(256.0 - k))
        return log_comb + k * torch.log(y) + (255.0 - k) * torch.log1p(-y)


@DISTRIBUTIONS.register(name="UnitGaussianDistribution")
class UnitGaussianDistribution:
    def log_prob(self, x: torch.Tensor, y: torch.Tensor):
        return -0.5 * (x - y) ** 2 - _HALF_LOG_2PI
