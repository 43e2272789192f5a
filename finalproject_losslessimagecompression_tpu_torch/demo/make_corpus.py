"""The file-codec demo's held-out corpora as arrays.

The repository's `demo/corpus_indomain/` (SyntheticImages, the training
family of configs/synthetic64.yaml) and `demo/corpus_natural/`
(NaturalSynthetic, the family of configs/natural64.yaml) hold six PNGs
each at sizes that exercise the model's own 64x64, tiling multiples and
non-divisible padding.  The package's datasets draw the same images from
the same seeds, so `corpus_arrays` regenerates them exactly, with no PNG
decoder:

    python -m finalproject_losslessimagecompression_tpu_torch.demo.make_corpus \\
        OUTDIR [--kind indomain|natural|both]

writes `<name>.npy` (uint8 [H, W, 3]) per file, and `<name>.png` too where
PIL imports, under OUTDIR/<kind>.  It never writes into the repository's
`demo/`, whose committed PNGs are the reference.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

from ..data.datasets import NaturalSynthetic, SyntheticImages
from . import ROOT

# (file stem, (H, W)): native model dims, multiples (tiling), and
# non-divisible sizes (the pad path); the repository's demo/make_corpus.py
SIZES = [
    ("img_64x64_a", (64, 64)),
    ("img_64x64_b", (64, 64)),
    ("img_128x128", (128, 128)),
    ("img_64x192", (64, 192)),
    ("img_80x100", (80, 100)),
    ("img_29x37", (29, 37)),
]
HELDOUT_SEED = 7  # train = 1, eval = 0 (configs/synthetic64.yaml)
KINDS = {"indomain": SyntheticImages, "natural": NaturalSynthetic}


def committed_dir(kind: str) -> str:
    """The repository's directory of the kind's committed PNGs."""
    return os.path.join(ROOT, "demo", f"corpus_{kind}")


def corpus_arrays(kind: str) -> Dict[str, np.ndarray]:
    """{file stem: uint8 [H, W, 3]} of the corpus `kind` ("indomain" or
    "natural"), equal to the committed PNGs' pixels."""
    if kind not in KINDS:
        raise ValueError(f"unknown corpus {kind!r} (one of {sorted(KINDS)})")
    out = {}
    for i, (name, (h, w)) in enumerate(SIZES):
        ds = KINDS[kind](size=(h, w, 3), length=i + 1, seed=HELDOUT_SEED)
        # item index i varies the per-image stream too; v = round(x * 256)
        # lands on the training loader's 1/256 grid, only the saturated 256
        # bin clips to 255
        out[name] = np.clip(np.round(ds[i] * 256.0), 0, 255).astype(np.uint8)
    return out


def write_corpus(kind: str, outdir: str, png: bool = True):
    """Write the corpus's files under `outdir` (`.npy`, and `.png` where
    `png` and PIL imports); returns the `.npy` paths in SIZES order."""
    demo = os.path.realpath(os.path.join(ROOT, "demo"))
    real = os.path.realpath(outdir)
    if real == demo or real.startswith(demo + os.sep):
        raise SystemExit(f"{outdir}: the repository's demo/ holds the "
                         "committed corpora; write somewhere else")
    try:
        from PIL import Image
    except ImportError:
        Image = None
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for name, arr in corpus_arrays(kind).items():
        paths.append(os.path.join(outdir, name + ".npy"))
        np.save(paths[-1], arr)
        if png and Image is not None:
            Image.fromarray(arr).save(os.path.join(outdir, name + ".png"),
                                      optimize=True)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--kind", choices=sorted(KINDS) + ["both"],
                    default="both")
    args = ap.parse_args(argv)
    kinds = sorted(KINDS) if args.kind == "both" else [args.kind]
    for kind in kinds:
        for p in write_corpus(kind, os.path.join(args.outdir, kind)):
            print("wrote", p)


if __name__ == "__main__":
    main()
