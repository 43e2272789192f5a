"""Discretized logistic over the 2^-nbits grid: log-likelihood and
sampler."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .rounding import round_to_grid


def dlogistic_log_prob(x, mean, logscale, nbits: int = 8, eps: float = 1e-8):
    """log P(x) = logsigmoid(x_pos) + log(1 - exp(logsigmoid(x_neg)
    - logsigmoid(x_pos)) + eps), in the -expm1 form, which is exact in the
    tails."""
    scale = torch.exp(logscale)
    half = 0.5 / 2 ** nbits
    x_pos = (x + half - mean) / scale
    x_neg = (x - half - mean) / scale
    log_f_pos = F.logsigmoid(x_pos)
    log_f_neg = F.logsigmoid(x_neg)
    # diff <= 0 mathematically; float32 saturation can round it slightly
    # positive, which would make log() NaN
    diff = torch.clamp(log_f_neg - log_f_pos, max=0.0)
    return log_f_pos + torch.log(-torch.expm1(diff) + eps)


def dlogistic_sample(mean, logscale, nbits: int = 8,
                     generator: torch.Generator | None = None,
                     eps: float = 1e-7):
    """Logistic inverse-CDF of a uniform in [eps, 1 - eps], affine by
    (mean, exp(logscale)), rounded to the grid.  The uniforms come from
    `generator`, which lies on the tensors' device."""
    u = torch.rand(mean.shape, generator=generator, dtype=mean.dtype,
                   device=mean.device) * (1.0 - 2 * eps) + eps
    std = torch.log(u / (1.0 - u))
    return round_to_grid(std * torch.exp(logscale) + mean, nbits)
