"""Demonstration harnesses, the counterparts of the repository's `demo/`
scripts (which drive the JAX package):

    make_corpus     the held-out corpora as arrays (`.npy`, PNG where PIL
                    imports)
    stress          50M logistic symbols through the interleaved coder:
                    host in the loop, the kernels and the plain torch path
    eval_phases     one `Trainer.evaluate` from a checkpoint, its phase
                    timers
    filecodec_demo  the file codec CLI over a corpus: exact round trips,
                    `.lic` bytes against PNG, lossless WebP and gzip -9,
                    one-shot and `serve` timings

Each is a plain function plus `main(argv)`:

    python -m finalproject_losslessimagecompression_tpu_torch.demo.<name> ...

and runs on the card unless given `--device cpu`.  Results are written
only to the `--out` path the caller names, which must not exist yet; the
JSON records the device as nvidia-smi names it (the card's name and power
limit).
"""

from __future__ import annotations

import json
import os
import subprocess

import torch

# the repository root: the committed corpora live under ROOT/demo
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def device_label(device) -> str:
    """'cpu', or the card as `nvidia-smi --query-gpu=name,power.limit`
    gives it (its name and power limit)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if out:
        return out[0]
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


def write_new(path: str, obj) -> str:
    """Write `obj` as indented JSON to `path`, a file that must not exist
    yet (a demo never overwrites a recorded result)."""
    if os.path.exists(path):
        raise SystemExit(f"{path} exists: name a new file for --out")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    print("wrote", path)
    return path
