"""Exactly-invertible layout transforms on NHWC tensors.

space_to_depth / depth_to_space use the package's own sub-pixel-major
channel order, channel = (dy * s + dx) * C + c, which is the JAX package's
order and NOT `pixel_unshuffle`'s (c * s * s + dy * s + dx).
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/s, W/s, C*s*s]."""
    if scale == 1:
        return x
    b, h, w, c = x.shape
    x = x.reshape(b, h // scale, scale, w // scale, scale, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // scale, w // scale, scale * scale * c)


def depth_to_space(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Exact inverse of space_to_depth."""
    if scale == 1:
        return x
    b, h, w, cs = x.shape
    c = cs // (scale * scale)
    x = x.reshape(b, h, w, scale, scale, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * scale, w * scale, c)


def patch_split(x, h: int, w: int):
    """[B, H, W, C] -> [B * (H//h) * (W//w), h, w, C] tiles, row-major over
    the tile grid.  Takes a torch tensor or a numpy array."""
    b, H, W, c = x.shape
    if H % h or W % w:
        raise ValueError(f"{H}x{W} does not tile into {h}x{w}")
    x = x.reshape(b, H // h, h, W // w, w, c)
    x = _permute(x, (0, 1, 3, 2, 4, 5))
    return x.reshape(b * (H // h) * (W // w), h, w, c)


def patch_merge(x, H: int, W: int):
    """Exact inverse of patch_split."""
    n, h, w, c = x.shape
    hh, ww = H // h, W // w
    x = x.reshape(n // (hh * ww), hh, ww, h, w, c)
    x = _permute(x, (0, 1, 3, 2, 4, 5))
    return x.reshape(n // (hh * ww), H, W, c)


def _permute(x, dims):
    return x.permute(*dims) if isinstance(x, torch.Tensor) else \
        x.transpose(dims)
