"""NN building blocks (PyTorch, NCHW inside).

- DenseLayer / DenseBlock: 1x1 conv -> 3x3 conv -> activation with DenseNet
  concatenation growth; the block's final 1x1 projection is zero-initialised
  so couplings and priors start as identity / zero.  A DenseBlock has two
  paths (`DenseBlock.grows_in_place`): the concatenation path, on cuDNN
  under autograd, and on the card's inference path one NHWC buffer that
  each layer's `ops.dense_conv` kernel grows in place.
- flax_conv / BatchNorm / ResBlock: convolutions initialised as flax's
  (lecun-normal kernel, zero bias), flax's BatchNorm, and the VQ-VAE's
  residual block.

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

from ..ops.dense_conv import dense_conv3x3
from ..registry import ACTIVATIONS
from .config import DenseBlockCfg

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the activations the buffer path's kernel applies: negative slope of each
_SLOPES = {"ReLU": 0.0, "LeakyReLU": 0.01}


def activation(name: str):
    if name == "ReLU":
        return F.relu
    if name == "Tanh":
        return torch.tanh
    if name == "LeakyReLU":
        return F.leaky_relu  # negative slope 0.01, as in flax
    if name in ACTIVATIONS:
        return ACTIVATIONS.get(name)
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
        self.slope = _SLOPES.get(act)
        self.dtype = _DTYPES[dtype]
        self.fuse = fuse
        self.growth = growth
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

    def kernel_operands(self):
        """(w [9, C, g], bias_a [g, 9], b3 [g]) of `ops.dense_conv3x3`: the
        fused layer's weights tap-major, W3 . b1 per tap, and the 3x3's
        bias (float32)."""
        w1 = self.conv1_kernel[:, :, 0, 0]  # [c, i]
        w3 = self.conv3_kernel  # [g, c, k, l]
        g, C = w3.shape[0], w1.shape[1]
        w = torch.einsum("ci,gckl->klig", w1, w3).reshape(9, C, g)
        bias_a = torch.einsum("gckl,c->gkl", w3, self.conv1_bias)
        return (w.contiguous(), bias_a.reshape(g, 9).contiguous(),
                self.conv3_bias)


class DenseBlock(nn.Module):
    """`depth` DenseLayers growing in_ch -> in_ch + growth_channel, then a
    zero-initialised 1x1 projection to `out_features`.

    Per-layer growth is the integer split growth_i = (i+1)*g//d - i*g//d.
    With cfg.dtype="bfloat16" the conv stack computes in bfloat16 (params
    stay float32) and the output is cast back to float32, so downstream grid
    arithmetic keeps its exactness.  `forward` takes and gives NCHW,
    `nhwc` NHWC.

    Two paths, picked per call by `grows_in_place` from the inputs alone:
    - the buffer path, where nothing can need a backward (autograd is not
      recording, or neither the input nor any parameter requires grad) on
      a float32 CUDA tensor, for a float32 block of fused layers whose
      activation is ReLU or LeakyReLU.  The block allocates one NHWC
      buffer of its full width (in_ch + the growths, the pitch rounded up
      to 4 channels), copies its input into the first in_ch channels, and
      each layer is one launch of `ops.dense_conv.dense_conv3x3`, which
      reads the buffer's channel prefix and writes its own channels after
      it; the projection is one matrix product over the buffer.
    - the concatenation path otherwise (training, a bfloat16 or unfused
      block, every CPU tensor): each DenseLayer's cuDNN convolutions and
      `torch.cat`, unchanged.
    The two compute the same function; their bits differ only by float
    rounding (the sums run in another order), which the benchmark judge's
    limits on the codec's latents and priors against its plain reference
    (`latents_off_ppm` 5000, `prior_gap` 1e-5) hold.  Each path gives the
    same bits for the same shapes on every call, so a codec's compress and
    decompress agree on either."""

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
        self.width = ch
        self.kernel_fits = (self.dtype == torch.float32 and cfg.fuse_1x1
                         and cfg.act in _SLOPES)

    def grows_in_place(self, x: torch.Tensor) -> bool:
        """Whether a call on `x` takes the buffer path (class docstring)."""
        if not (self.kernel_fits and x.is_cuda and x.dtype == torch.float32):
            return False
        return not torch.is_grad_enabled() or not (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.grows_in_place(x):
            return self.grow_in_place(x.permute(0, 2, 3, 1)).permute(
                0, 3, 1, 2)
        return self.concatenate(x)

    def nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """The block on an NHWC tensor, NHWC out.  On the concatenation
        path the input is made contiguous so that encode and decode, which
        slice it differently, present cuDNN the same layout and get the
        same algorithm."""
        if self.grows_in_place(x):
            return self.grow_in_place(x)
        y = self.concatenate(x.permute(0, 3, 1, 2).contiguous())
        return y.permute(0, 2, 3, 1)

    def concatenate(self, x: torch.Tensor) -> torch.Tensor:
        """The concatenation path, NCHW."""
        dt = self.dtype
        x = x.to(dt)
        for layer in self.layers:
            x = layer(x)
        out = F.conv2d(x, self.proj.weight.to(dt), self.proj.bias.to(dt))
        return out.to(torch.float32)

    def grow_in_place(self, x: torch.Tensor) -> torch.Tensor:
        """The buffer path, NHWC float32 in and out: `dense_conv3x3` runs
        its kernel on a CUDA tensor and its plain version on a CPU one."""
        n, h, w, c = x.shape
        buf = x.new_empty((n, h, w, -(-self.width // 4) * 4))
        buf[..., :c] = x
        for layer in self.layers:
            dense_conv3x3(buf, c, *layer.kernel_operands(), layer.slope)
            c += layer.growth
        out = torch.addmm(self.proj.bias, buf.view(-1, buf.shape[-1])[:, :c],
                          self.proj.weight[:, :, 0, 0].t())
        return out.view(n, h, w, -1)


_LAYER0 = "layers.0.conv1_kernel"


def pad_growth_params(state_dict, multiple: int):
    """Zero-pad every DenseBlock's growth channels in a state_dict of this
    package (an IDFlow's, or any model's holding DenseBlocks) so that it
    loads into the same model built with `growth_multiple=multiple`
    (`models.config.with_growth_multiple`), as the same function.

    Each layer's 3x3 conv gets zero output channels up to a multiple of
    `multiple`; they emit exactly 0.0, act(0) = 0 for ReLU, LeakyReLU and
    Tanh, and every weight that reads a padded channel downstream is zero.
    The padding is appended per layer, so a layer's original input
    channels stop being contiguous after the second layer: `old_idx`
    tracks where the unpadded stream's channels sit in the padded one.
    Other entries pass through unchanged."""
    out = dict(state_dict)
    for key in state_dict:
        if key.endswith(_LAYER0):
            out.update(_pad_block(state_dict, key[:-len(_LAYER0)], multiple))
    return out


def _pad_block(sd, prefix: str, multiple: int):
    old_idx = torch.arange(sd[prefix + _LAYER0].shape[0])
    width = len(old_idx)
    out = {}
    i = 0
    while f"{prefix}layers.{i}.conv1_kernel" in sd:
        p = f"{prefix}layers.{i}."
        w1, b1, w3, b3 = (sd[p + n] for n in (
            "conv1_kernel", "conv1_bias", "conv3_kernel", "conv3_bias"))
        if w1.shape[0] != len(old_idx):
            raise ValueError(f"{p}conv1_kernel has {w1.shape[0]} channels, "
                             f"the block's stream {len(old_idx)}")
        g = w3.shape[0]
        gp = -(-g // multiple) * multiple
        w1p = w1.new_zeros((width, width, 1, 1))
        w1p[old_idx[:, None], old_idx[None, :]] = w1
        b1p = b1.new_zeros(width)
        b1p[old_idx] = b1
        w3p = w3.new_zeros((gp, width) + tuple(w3.shape[2:]))
        w3p[:g, old_idx] = w3
        b3p = b3.new_zeros(gp)
        b3p[:g] = b3
        out.update({p + "conv1_kernel": w1p, p + "conv1_bias": b1p,
                    p + "conv3_kernel": w3p, p + "conv3_bias": b3p})
        old_idx = torch.cat([old_idx, width + torch.arange(g)])
        width += gp
        i += 1
    k = sd[prefix + "proj.weight"]
    kp = k.new_zeros((k.shape[0], width) + tuple(k.shape[2:]))
    kp[:, old_idx] = k
    out[prefix + "proj.weight"] = kp
    return out


def flax_conv(in_ch: int, out_ch: int, k: int, stride: int = 1,
              padding: int = 0, gen: torch.Generator | None = None,
              transpose: bool = False) -> nn.Module:
    """nn.Conv2d (or nn.ConvTranspose2d) initialised as a flax conv:
    lecun-normal kernel over fan_in = in_ch * k * k, zero bias."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    cls = nn.ConvTranspose2d if transpose else nn.Conv2d
    conv = cls(in_ch, out_ch, k, stride=stride, padding=padding)
    with torch.no_grad():
        conv.weight.copy_(_lecun_normal(conv.weight.shape, in_ch * k * k,
                                        gen))
        conv.bias.zero_()
    return conv


class BatchNorm(nn.Module):
    """flax's BatchNorm over the channels of an NCHW tensor: epsilon 1e-5,
    running averages updated as ra = 0.99 ra + 0.01 batch with the biased
    batch variance (torch's BatchNorm2d would store the unbiased one).
    `train=False` normalises with the running averages.

    `sum_over_ranks`, where a data-parallel trainer sets it (a
    differentiable sum over the ranks), makes the train-mode moments those
    of the global batch: the per-rank sums of x and x * x and the element
    counts are summed over the ranks before the division."""

    def __init__(self, ch: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.sum_over_ranks = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            dims = (0, 2, 3)
            if self.sum_over_ranks is None:
                mean, mean_sq = x.mean(dim=dims), (x * x).mean(dim=dims)
            else:
                n = torch.full_like(x[0, :, 0, 0], x.numel() // x.shape[1])
                sums = self.sum_over_ranks(torch.stack(
                    [x.sum(dim=dims), (x * x).sum(dim=dims), n]))
                mean, mean_sq = sums[0] / sums[2], sums[1] / sums[2]
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * inv[:, None, None] + \
            self.bias[:, None, None]


class ResBlock(nn.Module):
    """3x3 conv -> ReLU -> 3x3 conv, ReLU after the residual add; optional
    BatchNorm after each conv.  NCHW."""

    def __init__(self, ch: int, batch_norm: bool = False,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.conv_a = flax_conv(ch, ch, 3, padding=1, gen=gen)
        self.conv_b = flax_conv(ch, ch, 3, padding=1, gen=gen)
        self.batch_norm = batch_norm
        if batch_norm:
            self.bn_a, self.bn_b = BatchNorm(ch), BatchNorm(ch)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.relu(self.conv_a(x))
        if self.batch_norm:
            h = self.bn_a(h, train)
        h = self.conv_b(h)
        if self.batch_norm:
            h = self.bn_b(h, train)
        return F.relu(x + h)
