"""Frozen config dataclasses for the model stack.

The port's own copy of the JAX package's `models/config.py` (the dataclasses
there are framework-free, but that package's `models/__init__.py` imports
flax, so the port copies rather than imports them).  Field names, defaults
and the `from_ref` parsers are identical, so one YAML config drives both
packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class DenseBlockCfg:
    """DenseNet-style block config."""

    growth_channel: int = 512
    depth: int = 8
    act: str = "ReLU"
    # computation dtype of the conv stack ("float32" or "bfloat16"); params
    # stay float32 and the block's output is cast back to float32
    dtype: str = "float32"
    # fold each layer's 1x1 conv into its 3x3 (exact composition in weight
    # space; see models/layers.py:DenseLayer)
    fuse_1x1: bool = True
    # opt-in, non-parity: round each layer's growth up to a multiple of this
    # (0 = off, every shipped config)
    growth_multiple: int = 0

    @classmethod
    def from_ref(cls, cfg: dict) -> "DenseBlockCfg":
        cfg = dict(cfg)
        cfg.pop("name", None)
        layer = dict(cfg.pop("layer", {}))
        layer.pop("name", None)
        act = layer.pop("act", "ReLU")
        return cls(
            growth_channel=cfg.pop("growth_channel", 512),
            depth=cfg.pop("depth", 8),
            act=act,
            dtype=cfg.pop("dtype", "float32"),
            fuse_1x1=cfg.pop("fuse_1x1", True),
            growth_multiple=cfg.pop("growth_multiple", 0),
        )


@dataclass(frozen=True)
class CouplingCfg:
    """Additive coupling config."""

    split: float = 0.75
    nn: DenseBlockCfg = field(default_factory=DenseBlockCfg)
    nbits: int = 8

    @classmethod
    def from_ref(cls, cfg: dict) -> "CouplingCfg":
        cfg = dict(cfg)
        cfg.pop("name", None)
        rnd = dict(cfg.pop("round", {}) or {})
        rnd.pop("name", None)
        return cls(
            split=cfg.pop("split", 0.75),
            nn=DenseBlockCfg.from_ref(cfg.pop("nn", {}) or {}),
            nbits=rnd.pop("nbits", None) or 8,
        )


@dataclass(frozen=True)
class FlowCfg:
    """IDFlow config."""

    H: int = 64
    W: int = 64
    C: int = 3
    nflows: int = 8
    nbits: int = 8
    nsplit: int = 3
    extend_scale: int = 2
    couple: CouplingCfg = field(default_factory=CouplingCfg)
    prior_nn: DenseBlockCfg = field(default_factory=DenseBlockCfg)
    batch_squeeze: int = 0
    conditional: bool = False
    conv_for_cond: bool = False
    cond_channels: int = 3
    perm_seed: int = 0

    @classmethod
    def from_ref(cls, cfg: dict, conditional: bool = False) -> "FlowCfg":
        cfg = dict(cfg)
        name = cfg.pop("name", "IDFlows")
        conditional = conditional or name == "ConditionalFlows"
        extend = dict(cfg.pop("extenddim", {}) or {})
        extend.pop("name", None)
        prior = dict(cfg.pop("prior", {}) or {})
        prior.pop("name", None)
        prior.pop("round", None)
        rnd = dict(cfg.pop("round", {}) or {})
        rnd.pop("name", None)
        cfg.pop("distribution", None)
        cfg.pop("load_path", None)
        C = cfg.pop("C", 3)
        return cls(
            C=C,
            cond_channels=C,
            H=cfg.pop("H", 64),
            W=cfg.pop("W", 64),
            nflows=cfg.pop("nflows", 8),
            nbits=cfg.pop("nbits", 8),
            nsplit=cfg.pop("nsplit", 3),
            extend_scale=extend.pop("scale", 2),
            couple=CouplingCfg.from_ref(cfg.pop("couple", {}) or {}),
            prior_nn=DenseBlockCfg.from_ref(prior.pop("nn", {}) or {}),
            batch_squeeze=cfg.pop("batch_squeeze", 0),
            conditional=conditional,
            conv_for_cond=cfg.pop("conv_for_cond", False),
            perm_seed=cfg.pop("perm_seed", 0),
        )


@dataclass(frozen=True)
class LevelPlan:
    """Static channel/shape bookkeeping for one split level."""

    channel: int  # channels entering the flow steps (after squeeze)
    z_ch: int  # factored-out channels
    keep_ch: int  # channels continuing to the next level (0 at last level)
    h: int
    w: int
    cond_ch: int  # conditioning channels at this level (0 if unconditional)


def level_plans(cfg: FlowCfg) -> Tuple[LevelPlan, ...]:
    """Per-level channel and spatial arithmetic of the multi-scale flow."""
    channel = cfg.C * (cfg.batch_squeeze if cfg.batch_squeeze else 1)
    h, w = cfg.H, cfg.W
    s = cfg.extend_scale
    cond_ch = cfg.cond_channels if cfg.conditional else 0
    plans = []
    for level in range(cfg.nsplit):
        channel *= s * s
        h //= s
        w //= s
        cond_ch_l = cond_ch * (s * s) ** (level + 1) if cfg.conditional else 0
        if level < cfg.nsplit - 1:
            z_ch = channel // 2
            keep_ch = channel - channel // 2
        else:
            z_ch = channel
            keep_ch = 0
        plans.append(
            LevelPlan(
                channel=channel,
                z_ch=z_ch,
                keep_ch=keep_ch,
                h=h,
                w=w,
                cond_ch=cond_ch_l,
            )
        )
        channel = keep_ch
    return tuple(plans)


def latent_shapes(cfg: FlowCfg) -> Tuple[Tuple[int, int, int], ...]:
    """NHWC latent shapes per split level."""
    return tuple((p.h, p.w, p.z_ch) for p in level_plans(cfg))


def with_growth_multiple(cfg: FlowCfg, multiple: int) -> FlowCfg:
    """The same flow config with every DenseBlock's per-layer growth
    rounded up to a multiple of `multiple` output channels per 3x3 conv.
    Pair with `models.layers.pad_growth_params` to run a trained
    checkpoint through the wider architecture as the same function."""
    return replace(
        cfg,
        couple=replace(cfg.couple,
                       nn=replace(cfg.couple.nn, growth_multiple=multiple)),
        prior_nn=replace(cfg.prior_nn, growth_multiple=multiple),
    )
