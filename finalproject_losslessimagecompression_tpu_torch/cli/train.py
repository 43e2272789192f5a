"""Training entry point:

    python -m finalproject_losslessimagecompression_tpu_torch.cli.train \\
        --config configs/<name>.yaml [--set dotted.path=value ...] [--device cpu]

One --config YAML whose `train` subtree selects a trainer by name
(`train.trainer`: Trainer, the default, VQVAETrainer, ResidualTrainer,
TwoLevelTrainer or Finetuner) and passes the rest as constructor kwargs;
the same files drive the JAX package's trainers.  The YAML is read by the
port's own subset reader (`cli/yamlite.py`), so training needs no
PyYAML.  The trainer runs on the card unless `--device cpu` is given.

Several ranks (`use_mesh: true` in the config, `shard: true` on its
loaders):

    torchrun --nproc_per_node N -m \
        finalproject_losslessimagecompression_tpu_torch.cli.train \
        --config configs/<name>.yaml --distributed

`--distributed` (or LIC_DISTRIBUTED=1) joins the process group from the
torchrun variables (`parallel.mesh.init_distributed`: NCCL, one card per
rank; gloo with `--device cpu`) and raises without them.
"""

from __future__ import annotations

import argparse
import json
import os

from ..registry import TRAINERS
from ..train import finetuner as _finetuner  # noqa: F401 (registers)
from ..train import residual_trainer as _residual  # noqa: F401 (registers)
from ..train import trainer as _trainer  # noqa: F401 (registers Trainer)
from ..train import twolevel_trainer as _twolevel  # noqa: F401 (registers)
from ..train import vqvae_trainer as _vqvae  # noqa: F401 (registers)
from . import yamlite

def load_config(path: str) -> dict:
    return yamlite.load(path)


def apply_overrides(config: dict, sets) -> dict:
    """Apply `--set dotted.path=value` overrides in place.

    Values parse as YAML scalars (`5000` -> int, `true` -> bool, quoted
    strings stay strings) or one-line lists of them (`[215, 178, 3]`), and
    a string that reads as a float (`1e-4`, which YAML 1.1 leaves a string)
    becomes one.  Intermediate dicts are
    created as needed, so a path can introduce a new key; a path through a
    non-dict raises."""
    for item in sets or ():
        key, sep, raw = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects dotted.path=value, got {item!r}")
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):
                raise SystemExit(
                    f"--set {key}: {p!r} is a {type(nxt).__name__}, "
                    "not a mapping"
                )
            node = nxt
        value = yamlite.parse_value(raw)
        if isinstance(value, str):
            try:
                value = float(value)
            except ValueError:
                pass
        node[parts[-1]] = value
    return config


def build_trainer(config: dict, device=None):
    train_cfg = dict(config["train"])
    name = train_cfg.pop("trainer", "Trainer")
    return TRAINERS.get(name)(**train_cfg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument(
        "--device", type=str, default=None,
        help="torch device to train on (default: the card; 'cpu' to run "
        "on the CPU)",
    )
    ap.add_argument(
        "--distributed", action="store_true",
        help="multi-process training: join the process group from the "
        "torchrun variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
        "MASTER_PORT; or LIC_DISTRIBUTED=1). Pair with `shard: true` on the "
        "dataloaders so each rank draws a disjoint slice of every epoch.",
    )
    ap.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override a config entry by dotted path, e.g. "
        "--set train.max_step=5000 --set train.save_path=./logs/x.ckpt; "
        "values parse as YAML scalars. Repeatable.",
    )
    args = ap.parse_args(argv)
    if args.distributed or os.environ.get("LIC_DISTRIBUTED", "") == "1":
        import torch.distributed as dist

        from ..parallel.mesh import init_distributed

        device = init_distributed(
            "gloo" if args.device == "cpu" else None, args.device)
        print(f"torch.distributed: rank {dist.get_rank()} of "
              f"{dist.get_world_size()} ({dist.get_backend()}), device "
              f"{device}")
    config = apply_overrides(load_config(args.config), args.set)
    print(json.dumps(config, indent=2))
    t = build_trainer(config, device=args.device)
    t.train()
    return t


if __name__ == "__main__":
    main()
