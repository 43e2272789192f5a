"""Multi-scale integer discrete flow (IDFlow) with optional conditioning.

Per split level: squeeze (space-to-depth) -> nflows x [channel permute ->
additive coupling] -> final permute -> factor out z (half the channels) with
a discretized-logistic prior predicted from the kept half.  The last level
factors everything, and its prior sees zeros (learned constants).  The
conditional flow (ConditionalFlows) concatenates a per-level downscaled
conditioning image to every prior's input: a chain of 4x4 stride-2 convs
(`conv_for_cond`) or repeated space-to-depth.

Public tensors are NHWC, as in the JAX package; the DenseBlocks compute in
NCHW inside, or in one NHWC buffer on the card's inference path
(`layers.DenseBlock`).  The model lives on the card unless the caller asks
for the CPU: `IDFlow(cfg)` with no CUDA available raises.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.dlogistic import dlogistic_log_prob
from ..ops.reshape import depth_to_space, space_to_depth
from ..ops.rounding import round_to_grid
from .config import FlowCfg, latent_shapes, level_plans
from .invertible import (
    AdditiveCoupling,
    Prior,
    coupling_split,
    inverse_permutation,
    permutation,
)
from .layers import flax_conv


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def flow_permutations(cfg: FlowCfg):
    """All channel permutations: perms[level][0..nflows] (one before each
    coupling plus a final one)."""
    plans = level_plans(cfg)
    return [
        [
            permutation(cfg.perm_seed, level, step, plans[level].channel)
            for step in range(cfg.nflows + 1)
        ]
        for level in range(cfg.nsplit)
    ]


def fold_batch(x: torch.Tensor, batch_squeeze: int) -> torch.Tensor:
    """Fold the batch into channels: pad it by repeating sample 0 up to
    `batch_squeeze`, then [B, H, W, C] -> [1, H, W, B*C]."""
    b = x.shape[0]
    if b < batch_squeeze:
        x = torch.cat([x, x[:1].expand(batch_squeeze - b, *x.shape[1:])])
    b, h, w, c = x.shape
    return x.permute(1, 2, 0, 3).reshape(1, h, w, b * c)


def unfold_batch(x: torch.Tensor, channels: int) -> torch.Tensor:
    """Inverse of fold_batch back to [B, H, W, channels]."""
    _, h, w, bc = x.shape
    b = bc // channels
    return x.reshape(h, w, b, channels).permute(2, 0, 1, 3)


class IDFlow(nn.Module):
    """The IDFlow (ConditionalFlows when cfg.conditional).  Weights are
    drawn from a torch.Generator seeded with `seed` (lecun-normal convs,
    zero projections, as in flax); load trained or converted weights with
    `load_state_dict`."""

    def __init__(self, cfg: FlowCfg, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.plans = level_plans(cfg)
        gen = torch.Generator().manual_seed(seed)
        self.couples = nn.ModuleList()
        self.priors = nn.ModuleList()
        for level, p in enumerate(self.plans):
            self.couples.append(nn.ModuleList(
                AdditiveCoupling(p.channel, cfg.couple, gen)
                for _ in range(cfg.nflows)
            ))
            last = level == cfg.nsplit - 1
            prior_in = (p.z_ch if last else p.keep_ch) + p.cond_ch
            self.priors.append(Prior(prior_in, p.z_ch, cfg.prior_nn, gen=gen))
        if cfg.conditional and cfg.conv_for_cond:
            # level l's features come from level l - 1's, as in flax
            ins = [cfg.cond_channels] + [p.cond_ch for p in self.plans[:-1]]
            self.cond_convs = nn.ModuleList(
                flax_conv(c, p.cond_ch, 4, 2, 1, gen)
                for c, p in zip(ins, self.plans))
        self.a_chs = [coupling_split(p.channel, cfg.couple.split)[0]
                      for p in self.plans]
        self.perms = flow_permutations(cfg)
        self.inv_perms = [
            [inverse_permutation(q) for q in lvl] for lvl in self.perms
        ]
        # the gathers' indices live on the model's device, so applying a
        # permutation copies nothing from the host
        for level in range(cfg.nsplit):
            for step in range(cfg.nflows + 1):
                for name, q in (("perm", self.perms[level][step]),
                                ("inv_perm", self.inv_perms[level][step])):
                    self.register_buffer(
                        f"{name}_{level}_{step}",
                        torch.as_tensor(q, dtype=torch.int64),
                        persistent=False)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.priors[0].net.proj.weight.device

    @property
    def latent_shapes(self):
        return latent_shapes(self.cfg)

    def _take(self, x: torch.Tensor, name: str, level: int, step: int):
        return x.index_select(-1, getattr(self, f"{name}_{level}_{step}"))

    # -- the two NN functions both codec directions share -------------------

    def couple_t(self, xa: torch.Tensor, level: int, step: int):
        """Rounded coupling shift for (level, step)."""
        return self.couples[level][step].t(xa)

    def prior_params(self, ref: torch.Tensor, level: int, cond_l=None):
        """(mean, logscale) for level's z.  `ref` is the kept half for
        non-last levels and any z-shaped tensor at the last level (only its
        shape is used: the prior there sees zeros).  A conditional flow
        concatenates `cond_l`, the level's conditioning features, on the
        channel axis."""
        last = level == self.cfg.nsplit - 1
        h = torch.zeros_like(ref) if last else ref
        if self.cfg.conditional:
            h = torch.cat([h, cond_l], dim=-1)
        return self.priors[level](h)

    def cond_features(self, cond: torch.Tensor) -> List[torch.Tensor]:
        """Per-level NHWC conditioning features of an NHWC image: each
        level's from the previous level's, by a 4x4 stride-2 conv
        (conv_for_cond) or by space_to_depth."""
        feats, c = [], cond
        for level in range(self.cfg.nsplit):
            if self.cfg.conv_for_cond:
                c = self.cond_convs[level](
                    c.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
            else:
                c = space_to_depth(c, self.cfg.extend_scale)
            feats.append(c)
        return feats

    def _conds(self, cond):
        return self.cond_features(cond) if self.cfg.conditional else \
            [None] * self.cfg.nsplit

    # -- one level --------------------------------------------------------

    def flow_level(self, x: torch.Tensor, level: int) -> torch.Tensor:
        a = self.a_chs[level]
        for step in range(self.cfg.nflows):
            x = self._take(x, "perm", level, step)
            xa, xb = x[..., :a], x[..., a:]
            x = torch.cat([xa, xb + self.couple_t(xa, level, step)], dim=-1)
        return self._take(x, "perm", level, self.cfg.nflows)

    def flow_level_inverse(self, x: torch.Tensor, level: int) -> torch.Tensor:
        a = self.a_chs[level]
        x = self._take(x, "inv_perm", level, self.cfg.nflows)
        for step in range(self.cfg.nflows - 1, -1, -1):
            za, zb = x[..., :a], x[..., a:]
            x = torch.cat([za, zb - self.couple_t(za, level, step)], dim=-1)
            x = self._take(x, "inv_perm", level, step)
        return x

    # -- main paths -------------------------------------------------------

    def forward(self, x: torch.Tensor, cond=None):
        """Forward transform -> (latents, means, logscales) per split level,
        all NHWC.  `cond` is the conditioning image of a conditional flow
        (not folded by batch_squeeze, as in the JAX package)."""
        cfg = self.cfg
        if cfg.batch_squeeze:
            x = fold_batch(x, cfg.batch_squeeze)
        conds = self._conds(cond)
        latents, means, logscales = [], [], []
        for level, p in enumerate(self.plans):
            x = space_to_depth(x, cfg.extend_scale)
            x = self.flow_level(x, level)
            if level < cfg.nsplit - 1:
                z, keep = x[..., : p.z_ch], x[..., p.z_ch:]
            else:
                z, keep = x, x
            mean, logscale = self.prior_params(
                keep if level < cfg.nsplit - 1 else z, level, conds[level])
            latents.append(z)
            means.append(mean)
            logscales.append(logscale)
            x = keep
        return latents, means, logscales

    def inverse_from_latents(self, latents: Sequence[torch.Tensor]):
        """Invert exact latents back to the input (the couplings see no
        conditioning, so a conditional flow needs no `cond` here)."""
        cfg = self.cfg
        x = None
        for level in range(cfg.nsplit - 1, -1, -1):
            z = latents[level]
            x = z if level == cfg.nsplit - 1 else torch.cat([z, x], dim=-1)
            x = self.flow_level_inverse(x, level)
            x = depth_to_space(x, cfg.extend_scale)
        if cfg.batch_squeeze:
            x = unfold_batch(x, cfg.C)
        return x

    def sample_from_noise(self, noises: Sequence[torch.Tensor], cond=None):
        """Map standard-logistic noise latents (NHWC, one per level) through
        the priors and the inverse flow: at each level, from nsplit-1 down,
        z = round(noise * exp(logscale) + mean) with the prior of the data
        generated so far."""
        cfg = self.cfg
        conds = self._conds(cond)
        x = None
        for level in range(cfg.nsplit - 1, -1, -1):
            noise = noises[level]
            last = level == cfg.nsplit - 1
            mean, logscale = self.prior_params(noise if last else x, level,
                                               conds[level])
            z = round_to_grid(noise * torch.exp(logscale) + mean, cfg.nbits)
            x = z if last else torch.cat([z, x], dim=-1)
            x = depth_to_space(self.flow_level_inverse(x, level),
                               cfg.extend_scale)
        if cfg.batch_squeeze:
            x = unfold_batch(x, cfg.C)
        return x


def log_likelihood(cfg: FlowCfg, latents, means, logscales
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Per-sample log-likelihood in nats/dim plus per-split mean log-probs
    (normalised by H*W*C)."""
    log_prob = torch.zeros(latents[0].shape[0], device=latents[0].device)
    per_split = []
    for z, mean, logscale in zip(latents, means, logscales):
        logp = dlogistic_log_prob(z, mean, logscale, cfg.nbits)
        per_split.append(logp.mean(dim=(1, 2, 3)))
        log_prob = log_prob + logp.sum(dim=(1, 2, 3))
    return log_prob / (cfg.H * cfg.W * cfg.C), per_split
