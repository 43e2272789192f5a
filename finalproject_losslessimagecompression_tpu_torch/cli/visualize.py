"""Visualization: sample grids and latent-space interpolation.

    python -m finalproject_losslessimagecompression_tpu_torch.cli.visualize \\
        --config configs/vis_config_imagenet64.yaml \\
        [--mode sample|interpolate|both] [--out ./vis_out] [--device cpu]

- Sample: per-level standard discretized-logistic noise (from a seeded
  `torch.Generator` on the device) scaled by each temperature goes through
  `IDFlow.sample_from_noise`; one grid PNG per temperature.
- Interpolate: the latents of four corner images (TL, TR, BL, BR) of the
  test loader, normalised per level as (z - mean) / exp(logscale), are
  mixed bilinearly over an N x N grid and mapped back through the sampling
  path, all N * N images in one batch.

The config is a vis config of the JAX package (`train.model` with its
`load_path`, a checkpoint of either package, and `train.test_dataloader`),
read by the port's own YAML reader.  Grids are written under
`<out>/images` by `MetricsWriter.add_image_grid` (where PIL imports).  The
model runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..convert import params_from_flax
from ..data import loader as _loader  # noqa: F401  (registers loaders)
from ..models.config import FlowCfg, latent_shapes
from ..models.idflow import IDFlow
from ..ops.dlogistic import dlogistic_sample
from ..registry import DATALOADERS, build
from ..train.checkpoint import load_params
from ..train.metrics import MetricsWriter
from . import yamlite

TEMPERATURES = (0.25, 0.5, 0.75, 1.0)


def load_model(model_cfg: dict, device=None):
    """(cfg, IDFlow in eval mode) of a config's `model` subtree, with the
    weights of its `load_path` when it names one."""
    model_cfg = dict(model_cfg)
    load_path = model_cfg.pop("load_path", None)
    cfg = FlowCfg.from_ref(model_cfg)
    model = IDFlow(cfg, device=device)
    if load_path:
        model.load_state_dict(load_params(load_path, model.device,
                                          params_from_flax))
    return cfg, model.eval()


def sample_noise(cfg: FlowCfg, batch: int,
                 gen: torch.Generator) -> List[torch.Tensor]:
    """Standard discretized-logistic noise of every level's latent shape,
    on the generator's device."""
    noises = []
    for s in latent_shapes(cfg):
        zero = torch.zeros((batch,) + tuple(s), device=gen.device)
        noises.append(dlogistic_sample(zero, zero, cfg.nbits, gen))
    return noises


@torch.no_grad()
def sample(cfg: FlowCfg, model: IDFlow, writer: MetricsWriter,
           batch: int = 16, temperatures: Sequence[float] = TEMPERATURES,
           seed: int = 0, noises=None) -> Dict[float, torch.Tensor]:
    """{temperature: sampled images [batch, H, W, C]}, one grid each
    (`sample_t<t>`).  `noises` (one tensor per level) replaces the seeded
    draw."""
    if noises is None:
        gen = torch.Generator(device=model.device).manual_seed(seed)
        noises = sample_noise(cfg, batch, gen)
    out = {}
    for t in temperatures:
        img = model.sample_from_noise([n * t for n in noises])
        writer.add_image_grid(f"sample_t{t}", img.cpu().numpy(), 0)
        out[t] = img
    return out


@torch.no_grad()
def interpolate(cfg: FlowCfg, model: IDFlow, writer: MetricsWriter,
                corners, grid: int = 8) -> torch.Tensor:
    """The grid x grid images [grid * grid, H, W, C] between four corner
    images [4, H, W, C] (TL, TR, BL, BR), row-major, as one grid PNG."""
    corners = torch.as_tensor(np.asarray(corners), device=model.device)
    latents, means, logscales = model(corners)
    normed = [(z - m) / torch.exp(ls)
              for z, m, ls in zip(latents, means, logscales)]
    mixed = [[] for _ in normed]
    for i in range(grid):
        a = i / (grid - 1)
        for j in range(grid):
            b = j / (grid - 1)
            for acc, z in zip(mixed, normed):
                acc.append((1 - a) * (1 - b) * z[0] + (1 - a) * b * z[1]
                           + a * (1 - b) * z[2] + a * b * z[3])
    imgs = model.sample_from_noise([torch.stack(m) for m in mixed])
    writer.add_image_grid("interpolate", imgs.cpu().numpy(), 0, nrow=grid)
    return imgs


def corner_images(loader) -> np.ndarray:
    """The first four images of a loader's first batch (tiled when the
    batch holds fewer)."""
    batch = next(iter(loader))
    corners = batch[:4]
    if corners.shape[0] < 4:
        corners = np.tile(corners, (4, 1, 1, 1))[:4]
    return corners


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--mode", default="sample",
                    choices=["sample", "interpolate", "both"])
    ap.add_argument("--out", default="./vis_out")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    tc = yamlite.load(args.config)["train"]
    cfg, model = load_model(tc["model"], args.device)
    writer = MetricsWriter(args.out, use_tensorboard=False)
    if args.mode in ("sample", "both"):
        sample(cfg, model, writer)
        print(f"sample grids written under {args.out}/images")
    if args.mode in ("interpolate", "both"):
        loader = build(DATALOADERS, dict(tc["test_dataloader"]))
        interpolate(cfg, model, writer, corner_images(loader))
        print(f"interpolation grid written under {args.out}/images")
    writer.close()


if __name__ == "__main__":
    main()
