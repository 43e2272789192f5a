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

# the repository root: the committed corpora live under ROOT/demo
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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
