"""One `Trainer.evaluate` from a trained checkpoint, with its phase timers.

The trainer is built from the config as `cli.train` builds it, its model
restored from `--ckpt` (a trainer checkpoint of this package, or of the
JAX package through the converter); eval computes the test bpd of
`--batches` test batches and, where the config has `test_coding`,
compresses and decompresses each batch for real (on the card: the rANS
kernels), counting values that differ and the coded bpd.  The phase
timers are fenced: `forward` ends in a host copy of the loss, `encode` in
the containers' bytes, `decode` in the decoded batch on the host.

    python -m finalproject_losslessimagecompression_tpu_torch.demo.eval_phases \\
        --ckpt logs/synthetic64.ckpt [--config configs/synthetic64.yaml] \\
        [--batches 2] [--device cpu] [--out results/torch_h100/eval.json]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from ..cli.train import build_trainer, load_config
from ..models.idflow import resolve_device
from ..utils.profiling import device_label
from . import write_new


def run(config: str, ckpt: str, batches: int = 2, device=None) -> dict:
    device = resolve_device(device)
    cfg = load_config(config)
    t = cfg["train"]
    t["model"] = dict(t["model"], load_path=ckpt)
    t["max_eval_batches"] = batches
    with tempfile.TemporaryDirectory() as tmp:
        # the trainer opens its metrics writer at construction; nothing is
        # trained or saved here
        t["writer_path"] = os.path.join(tmp, "log")
        t["save_path"] = os.path.join(tmp, "unused.ckpt")
        trainer = build_trainer(cfg, device=device)
        ev = trainer.evaluate()
    return {
        "what": "one Trainer.evaluate from a checkpoint, its phase timers "
                "fenced (forward ends in a host copy of the loss, encode in "
                "the containers' bytes, decode in the batch on the host)",
        "device": device_label(device),
        "config": config,
        "ckpt": os.path.basename(ckpt),
        "eval": ev,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/synthetic64.yaml")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                    "the CPU)")
    ap.add_argument("--out", default=None,
                    help="a new JSON file for the result")
    args = ap.parse_args(argv)
    out = run(args.config, args.ckpt, args.batches, args.device)
    print(json.dumps(out, indent=1))
    if args.out:
        write_new(args.out, out)
    return out


if __name__ == "__main__":
    main()
