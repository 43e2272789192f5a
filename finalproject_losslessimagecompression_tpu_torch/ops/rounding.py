"""Straight-through rounding to the 2^-nbits grid.

The forward value is round(x * 2^nbits) / 2^nbits with round-half-to-even
(`torch.round`, like `jnp.round`); the gradient passes through unchanged.
"""

from __future__ import annotations

import torch


class _RoundST(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


def round_ste(x: torch.Tensor, nbits: int = 8) -> torch.Tensor:
    """Round to the 2^-nbits grid with a straight-through gradient."""
    bins = float(2 ** nbits)
    return _RoundST.apply(x * bins) / bins


def round_to_grid(x: torch.Tensor, nbits: int = 8) -> torch.Tensor:
    """Non-differentiable grid rounding."""
    bins = float(2 ** nbits)
    return torch.round(x * bins) / bins
