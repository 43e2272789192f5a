"""NN building blocks (PyTorch, NCHW inside).

- DenseLayer / DenseBlock: 1x1 conv -> 3x3 conv -> activation with DenseNet
  concatenation growth; the block's final 1x1 projection is zero-initialised
  so couplings and priors start as identity / zero.

The parameters keep the JAX package's four leaves per layer
(`conv1_kernel`, `conv1_bias`, `conv3_kernel`, `conv3_bias`), stored OIHW.
`fuse` only changes how they are applied, so `convert.params_from_flax`
loads either flax layout into either form.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import DenseBlockCfg

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def activation(name: str):
    if name == "ReLU":
        return F.relu
    if name == "Tanh":
        return torch.tanh
    if name == "LeakyReLU":
        return F.leaky_relu  # negative slope 0.01, as in flax
    raise KeyError(f"unknown activation {name!r}")


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (+-2 sd) with variance 1/fan_in."""
    # the sd of a standard normal truncated to [-2, 2]
    sd = 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w * (math.sqrt(1.0 / fan_in) / sd)


class DenseLayer(nn.Module):
    """x -> concat(x, act(conv3x3(conv1x1(x)))), growing by `growth` channels.

    fuse=True (the default) computes the same function as one 3x3 conv: there
    is no nonlinearity between the 1x1 and the 3x3, so
    conv3(W3, conv1(W1, x) + b1) folds into conv(x, W1 @ W3) + T + b3, where
    T is the position-dependent bias field of the zero padding (border taps
    never see b1).  The fused and unfused forms differ only in float
    rounding."""

    def __init__(self, in_ch: int, growth: int, act: str = "ReLU",
                 dtype: str = "float32", fuse: bool = True,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.act = activation(act)
        self.dtype = _DTYPES[dtype]
        self.fuse = fuse
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        C, g = in_ch, growth
        self.conv1_kernel = nn.Parameter(_lecun_normal((C, C, 1, 1), C, gen))
        self.conv1_bias = nn.Parameter(torch.zeros(C))
        self.conv3_kernel = nn.Parameter(
            _lecun_normal((g, C, 3, 3), 9 * C, gen))
        self.conv3_bias = nn.Parameter(torch.zeros(g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if not self.fuse:
            h = F.conv2d(x, self.conv1_kernel.to(dt), self.conv1_bias.to(dt))
            h = F.conv2d(h, self.conv3_kernel.to(dt), self.conv3_bias.to(dt),
                         padding=1)
            return torch.cat([x, self.act(h)], dim=1)
        H, W = x.shape[2], x.shape[3]
        w1 = self.conv1_kernel[:, :, 0, 0]  # [c, i]
        w3 = self.conv3_kernel  # [g, c, k, l]
        # weight-space composition in float32, then the compute dtype
        w_eff = torch.einsum("ci,gckl->gikl", w1, w3).to(dt)
        # boundary bias field T[g, i, j]: sum over the taps (k, l) whose
        # input position is in bounds of W3[k, l] . b1
        A = torch.einsum("gckl,c->gkl", w3, self.conv1_bias)
        dev = x.device
        ri = torch.arange(H, device=dev)[None, :] + torch.arange(
            3, device=dev)[:, None] - 1
        mk = ((ri >= 0) & (ri < H)).to(torch.float32)  # [3, H]
        cj = torch.arange(W, device=dev)[None, :] + torch.arange(
            3, device=dev)[:, None] - 1
        ml = ((cj >= 0) & (cj < W)).to(torch.float32)  # [3, W]
        T = torch.einsum("ki,lj,gkl->gij", mk, ml, A) + self.conv3_bias[
            :, None, None]
        y = F.conv2d(x.to(dt), w_eff, padding=1)
        h = self.act(y + T.to(dt))
        return torch.cat([x, h], dim=1)


class DenseBlock(nn.Module):
    """`depth` DenseLayers growing in_ch -> in_ch + growth_channel, then a
    zero-initialised 1x1 projection to `out_features`.

    Per-layer growth is the integer split growth_i = (i+1)*g//d - i*g//d.
    With cfg.dtype="bfloat16" the conv stack computes in bfloat16 (params
    stay float32) and the output is cast back to float32, so downstream grid
    arithmetic keeps its exactness.  Input and output are NCHW."""

    def __init__(self, in_ch: int, out_features: int, cfg: DenseBlockCfg,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.dtype = _DTYPES[cfg.dtype]
        g, d = cfg.growth_channel, cfg.depth
        layers = []
        ch = in_ch
        for i in range(d):
            growth = (i + 1) * g // d - i * g // d
            if cfg.growth_multiple:
                m = cfg.growth_multiple
                growth = -(-growth // m) * m
            layers.append(DenseLayer(ch, growth, cfg.act, cfg.dtype,
                                     cfg.fuse_1x1, gen))
            ch += growth
        self.layers = nn.ModuleList(layers)
        self.proj = nn.Conv2d(ch, out_features, 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        for layer in self.layers:
            x = layer(x)
        out = F.conv2d(x, self.proj.weight.to(dt), self.proj.bias.to(dt))
        return out.to(torch.float32)
