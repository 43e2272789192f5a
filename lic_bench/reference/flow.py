"""Plain float32 IDFlow: the reference the benchmark judges the port by.

Written from the published architecture (lym01803/FinalProject-
LosslessImageCompression, `IDFlows`): per split level, squeeze
(space-to-depth, sub-pixel-major channel order), `nflows` x [channel
permutation, additive coupling zb = xb + round(NN(xa))], a final
permutation, then the level's z (half the channels) with a discretized
logistic prior predicted from the kept half; the last level factors
everything and its prior sees zeros.  Each NN is a DenseBlock: `depth`
DenseLayers (1x1 conv, then 3x3 conv, then the activation, concatenated to
the input), then a 1x1 projection.  The 1x1 and the 3x3 run as two
convolutions, as published: no fusion, no caching, no batching tricks.

Tensors are NHWC as in the package under test; the weights are a flat
dict named as that package's state_dict names them (`param_shapes` says
which), which the benchmark fills from its seed and hands to both sides.

`precision="tf32"` computes the convolutions in TF32, the nearest
precision below the float32 (TF32 off) the configuration states: on the
card by cuDNN's TF32 mode (`tf32_mode`, forward and backward), on the CPU
by rounding every convolution's input and weight to TF32's 10-bit
mantissa (gradients pass straight through).  It is the control of the
comparison.  The module imports nothing of the package under test.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LOGSCALE_MIN = -6.24  # the prior's logscale floor
LEAKY_SLOPE = 0.01


def pin_float32() -> None:
    """float32 convolutions and products, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def tf32_mode(on: bool):
    """cuDNN and cuBLAS in TF32 inside the block where `on`."""
    if not on:
        yield
        return
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        yield
    finally:
        pin_float32()


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits, ties to
    even), kept in float32; the gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    r = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


@dataclass(frozen=True)
class Block:
    growth: int
    depth: int
    act: str


@dataclass(frozen=True)
class Level:
    channel: int
    z_ch: int
    keep_ch: int
    h: int
    w: int
    a_ch: int
    cond_ch: int


@dataclass(frozen=True)
class Arch:
    H: int
    W: int
    C: int
    nflows: int
    nsplit: int
    nbits: int
    scale: int
    split: float
    couple: Block
    prior: Block
    conditional: bool
    conv_for_cond: bool
    perm_seed: int

    @property
    def levels(self) -> List[Level]:
        out, channel, h, w = [], self.C, self.H, self.W
        for level in range(self.nsplit):
            channel *= self.scale ** 2
            h //= self.scale
            w //= self.scale
            last = level == self.nsplit - 1
            z_ch = channel if last else channel // 2
            cond = (self.C * (self.scale ** 2) ** (level + 1)
                    if self.conditional else 0)
            out.append(Level(channel, z_ch, channel - z_ch, h, w,
                             int(channel * self.split), cond))
            channel -= z_ch
        return out


def arch(model: dict) -> Arch:
    """The architecture of a published `train.model` (or `flows`) entry."""
    def block(nn: dict) -> Block:
        return Block(nn["growth_channel"], nn["depth"], nn["layer"]["act"])

    return Arch(
        H=model["H"], W=model["W"], C=model["C"], nflows=model["nflows"],
        nsplit=model["nsplit"], nbits=model["nbits"],
        scale=model["extenddim"]["scale"], split=model["couple"]["split"],
        couple=block(model["couple"]["nn"]), prior=block(model["prior"]["nn"]),
        conditional=model["name"] == "ConditionalFlows",
        conv_for_cond=bool(model.get("conv_for_cond", False)),
        perm_seed=int(model.get("perm_seed", 0)))


def growths(b: Block) -> List[int]:
    return [(i + 1) * b.growth // b.depth - i * b.growth // b.depth
            for i in range(b.depth)]


def _block_shapes(prefix: str, c_in: int, out: int, b: Block, shapes):
    ch = c_in
    for i, g in enumerate(growths(b)):
        p = f"{prefix}layers.{i}."
        shapes[p + "conv1_kernel"] = (ch, ch, 1, 1)
        shapes[p + "conv1_bias"] = (ch,)
        shapes[p + "conv3_kernel"] = (g, ch, 3, 3)
        shapes[p + "conv3_bias"] = (g,)
        ch += g
    shapes[prefix + "proj.weight"] = (out, ch, 1, 1)
    shapes[prefix + "proj.bias"] = (out,)


def param_shapes(a: Arch) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every weight of the flow, named as the package's state_dict."""
    shapes: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
    levels = a.levels
    for li, lv in enumerate(levels):
        for step in range(a.nflows):
            _block_shapes(f"couples.{li}.{step}.dense.", lv.a_ch,
                          lv.channel - lv.a_ch, a.couple, shapes)
    for li, lv in enumerate(levels):
        last = li == a.nsplit - 1
        c_in = (lv.z_ch if last else lv.keep_ch) + lv.cond_ch
        _block_shapes(f"priors.{li}.net.", c_in, 2 * lv.z_ch, a.prior, shapes)
    if a.conditional and a.conv_for_cond:
        ins = [a.C] + [lv.cond_ch for lv in levels[:-1]]
        for li, (c, lv) in enumerate(zip(ins, levels)):
            shapes[f"cond_convs.{li}.weight"] = (lv.cond_ch, c, 4, 4)
            shapes[f"cond_convs.{li}.bias"] = (lv.cond_ch,)
    return shapes


def permutation(seed: int, level: int, step: int, dim: int) -> np.ndarray:
    """The published flow's channel permutation of (level, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, level, step,
                                                        dim]))
    return rng.permutation(dim)


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/s, W/s, s*s*C], channel (dy*s + dx)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // s, w // s, s * s * c)


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class Flow:
    """The plain flow over a weight dict (float32 tensors on one device)."""

    def __init__(self, a: Arch, weights: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(precision)
        self.a, self.w, self.precision = a, weights, precision
        self.levels = a.levels
        dev = next(iter(weights.values())).device
        self.card_tf32 = precision == "tf32" and dev.type == "cuda"
        self.emulate_tf32 = precision == "tf32" and dev.type != "cuda"
        self.perms = [[torch.as_tensor(permutation(a.perm_seed, li, st,
                                                   lv.channel), device=dev)
                       for st in range(a.nflows + 1)]
                      for li, lv in enumerate(self.levels)]

    # -- the NNs --------------------------------------------------------------

    def _conv(self, x, w, b, **kw):
        if self.emulate_tf32:
            x, w = to_tf32(x), to_tf32(w)
        return F.conv2d(x, w, b, **kw)

    def _act(self, name: str, x):
        if name == "ReLU":
            return F.relu(x)
        if name == "LeakyReLU":
            return F.leaky_relu(x, LEAKY_SLOPE)
        if name == "Tanh":
            return torch.tanh(x)
        raise KeyError(name)

    def dense_block(self, prefix: str, b: Block, x: torch.Tensor):
        """NHWC in, NHWC out: the published DenseBlock, unfused."""
        w = self.w
        h = x.permute(0, 3, 1, 2)
        for i in range(b.depth):
            p = f"{prefix}layers.{i}."
            y = self._conv(h, w[p + "conv1_kernel"], w[p + "conv1_bias"])
            y = self._conv(y, w[p + "conv3_kernel"], w[p + "conv3_bias"],
                           padding=1)
            h = torch.cat([h, self._act(b.act, y)], dim=1)
        out = self._conv(h, w[prefix + "proj.weight"], w[prefix + "proj.bias"])
        return out.permute(0, 2, 3, 1)

    def shift(self, xa, level: int, step: int):
        """The coupling's shift, rounded to the grid (straight-through)."""
        bins = float(2 ** self.a.nbits)
        t = self.dense_block(f"couples.{level}.{step}.dense.", self.a.couple,
                             xa)
        return _RoundSTE.apply(t * bins) / bins

    def prior(self, ref, level: int, cond_l=None):
        """(mean, logscale) of level's z from the kept half (zeros at the
        last level), with the level's conditioning features appended."""
        lv = self.levels[level]
        h = torch.zeros_like(ref) if level == self.a.nsplit - 1 else ref
        if self.a.conditional:
            h = torch.cat([h, cond_l], dim=-1)
        p = self.dense_block(f"priors.{level}.net.", self.a.prior, h)
        return p[..., :lv.z_ch], torch.clamp(p[..., lv.z_ch:],
                                             min=LOGSCALE_MIN)

    def cond_features(self, cond) -> List[Optional[torch.Tensor]]:
        if not self.a.conditional:
            return [None] * self.a.nsplit
        feats, c = [], cond
        for li in range(self.a.nsplit):
            if self.a.conv_for_cond:
                c = self._conv(c.permute(0, 3, 1, 2),
                               self.w[f"cond_convs.{li}.weight"],
                               self.w[f"cond_convs.{li}.bias"], stride=2,
                               padding=1).permute(0, 2, 3, 1)
            else:
                c = space_to_depth(c, self.a.scale)
            feats.append(c)
        return feats

    # -- one level and the whole flow -----------------------------------------

    def flow_level(self, x, level: int):
        a = self.levels[level].a_ch
        for step in range(self.a.nflows):
            x = x.index_select(-1, self.perms[level][step])
            xa, xb = x[..., :a], x[..., a:]
            x = torch.cat([xa, xb + self.shift(xa, level, step)], dim=-1)
        return x.index_select(-1, self.perms[level][self.a.nflows])

    def forward(self, x, cond=None):
        """Per level (z, keep, mean, logscale); keep is None at the last
        level."""
        with tf32_mode(self.card_tf32):
            return self._forward(x, cond)

    def _forward(self, x, cond):
        feats = self.cond_features(cond)
        out = []
        for li, lv in enumerate(self.levels):
            x = self.flow_level(space_to_depth(x, self.a.scale), li)
            last = li == self.a.nsplit - 1
            z, keep = (x, None) if last else (x[..., :lv.z_ch],
                                              x[..., lv.z_ch:])
            mean, logscale = self.prior(z if last else keep, li, feats[li])
            out.append((z, keep, mean, logscale))
            x = keep
        return out


def dlogistic_log_prob(x, mean, logscale, nbits: int):
    """log P(x) of the logistic discretized to the 2^-nbits grid."""
    scale = torch.exp(logscale)
    half = 0.5 / 2 ** nbits
    lp = F.logsigmoid((x + half - mean) / scale)
    ln = F.logsigmoid((x - half - mean) / scale)
    diff = torch.clamp(ln - lp, max=0.0)
    return lp + torch.log(-torch.expm1(diff) + 1e-8)


def nll(a: Arch, levels) -> torch.Tensor:
    """Mean negative log-likelihood in nats per input dim."""
    total = 0.0
    for z, _, mean, logscale in levels:
        total = total + dlogistic_log_prob(z, mean, logscale,
                                           a.nbits).sum(dim=(1, 2, 3))
    return -(total / (a.H * a.W * a.C)).mean()
