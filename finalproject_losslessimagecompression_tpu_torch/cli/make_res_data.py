"""Dump VQ-VAE residual datasets to npz: the offline form of the residual
trainer's per-step pipeline, for training residual flows without paying the
VQ-VAE's inference per step.

For each batch of the configured dataloader: reconstruct with the frozen
VQ-VAE checkpoint (`train.vqvae.checkpoint`, a `{"params": ...}` checkpoint
of this package), round to the 1/256 grid, and store the pairs:

  python -m finalproject_losslessimagecompression_tpu_torch.cli.make_res_data \\
      --config <residual-yaml> --out res_data.npz [--max-batches N] \\
      [--split train_dataloader|test_dataloader] [--device cpu]

The npz holds `residual` and `reconstruction` ([N, H, W, C] float32), and
residual + reconstruction is the loader's batch exactly.  It runs on the
card unless `--device cpu` is given; the config is read by the port's own
YAML reader.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..convert import vqvae_params_from_flax
from ..data import loader as _loader  # noqa: F401  (registers loaders)
from ..models.idflow import resolve_device
from ..models.vqvae import build_vqvae_from_ref
from ..ops.rounding import round_to_grid
from ..registry import DATALOADERS, build
from ..train.checkpoint import load_params
from .train import load_config


def make_res_data(config: dict, out: str, max_batches: int = 0,
                  split: str = "test_dataloader", device=None):
    """Write the npz of a residual config (the parsed YAML); returns the
    residual's shape."""
    device = resolve_device(device)
    tc = config["train"]
    vq_cfg = dict(tc["vqvae"])
    ckpt = vq_cfg.pop("checkpoint")
    vqvae = build_vqvae_from_ref(vq_cfg, device=device)
    vqvae.load_state_dict(load_params(ckpt, device, vqvae_params_from_flax))
    vqvae.eval()
    loader = build(DATALOADERS, dict(tc[split]))
    residuals, recs = [], []
    with torch.no_grad():
        for i, host in enumerate(iter(loader), 1):
            batch = torch.from_numpy(np.ascontiguousarray(host)).to(device)
            rec = vqvae.reconstruct((batch - 0.5) / 0.5) * 0.5 + 0.5
            rec = round_to_grid(rec, 8)
            residuals.append((batch - rec).cpu().numpy())
            recs.append(rec.cpu().numpy())
            if max_batches and i >= max_batches:
                break
    residual = np.concatenate(residuals)
    np.savez_compressed(out, residual=residual,
                        reconstruction=np.concatenate(recs))
    return residual.shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-batches", type=int, default=0)
    ap.add_argument("--split", default="test_dataloader",
                    choices=["train_dataloader", "test_dataloader"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                    "the CPU)")
    args = ap.parse_args(argv)
    shape = make_res_data(load_config(args.config), args.out,
                          args.max_batches, args.split, args.device)
    print(f"wrote {args.out}: residual {shape}")


if __name__ == "__main__":
    main()
