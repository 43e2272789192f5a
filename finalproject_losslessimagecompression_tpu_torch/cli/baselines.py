"""Classical-codec baselines: bpd and host seconds of gzip / bz2 / lzma
over raw bytes, PNG / WebP (lossless) through PIL and gzip of the PNG, over
any registered data loader -- the comparison panel for the learned codec's
real bpd.  The port's copy of the JAX package's `cli/baselines.py`; the
codecs run on the host, so there is no device to choose.

    python -m finalproject_losslessimagecompression_tpu_torch.cli.baselines \
        --config <yaml> [--max-batches N]

(the config's `train.test_dataloader`, read by the port's YAML reader; or
`--synthetic` for a data-free run).  PIL is imported only by the image
codecs.
"""

from __future__ import annotations

import argparse
import bz2
import gzip
import io
import lzma
import time

import numpy as np

from ..data import loader as _loader  # noqa: F401  (registers loaders)
from ..registry import DATALOADERS, build
from . import yamlite


def _to_uint8(batch: np.ndarray) -> np.ndarray:
    return np.clip(np.round(batch * 255.0), 0, 255).astype(np.uint8)


def compress_bytes(name: str, arr: np.ndarray) -> int:
    raw = arr.tobytes()
    if name == "gzip":
        return len(gzip.compress(raw, 9))
    if name == "bz2":
        return len(bz2.compress(raw, 9))
    if name == "lzma":
        return len(lzma.compress(raw))
    raise KeyError(name)


def compress_image(name: str, arr: np.ndarray) -> int:
    from PIL import Image

    img = Image.fromarray(arr)
    buf = io.BytesIO()
    if name == "png":
        img.save(buf, format="PNG", optimize=True)
    elif name == "webp":
        img.save(buf, format="WEBP", lossless=True)
    elif name == "gzip_png":
        tmp = io.BytesIO()
        img.save(tmp, format="PNG", optimize=True)
        return len(gzip.compress(tmp.getvalue(), 9))
    else:
        raise KeyError(name)
    return buf.tell()


def run(loader, max_batches: int = 0):
    codecs_b = ["gzip", "bz2", "lzma"]
    codecs_i = ["png", "webp", "gzip_png"]
    bits = {c: 0 for c in codecs_b + codecs_i}
    times = {c: 0.0 for c in codecs_b + codecs_i}
    dims = 0
    n_batches = 0
    for batch in iter(loader):
        u8 = _to_uint8(batch)
        dims += u8.size
        for c in codecs_b:
            t0 = time.time()
            for img in u8:
                bits[c] += 8 * compress_bytes(c, img)
            times[c] += time.time() - t0
        for c in codecs_i:
            t0 = time.time()
            for img in u8:
                bits[c] += 8 * compress_image(c, img)
            times[c] += time.time() - t0
        n_batches += 1
        if max_batches and n_batches >= max_batches:
            break
    return {
        c: {"bpd": bits[c] / dims, "seconds": times[c]}
        for c in bits
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--max-batches", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args(argv)
    if args.synthetic or not args.config:
        loader = build(
            DATALOADERS,
            dict(
                name="CustomDataLoader",
                dataset=dict(name="SyntheticImages", size=[64, 64, 3],
                             length=32, seed=0),
                batch_size=8,
                shuffle=False,
            ),
        )
    else:
        config = yamlite.load(args.config)
        loader = build(DATALOADERS, dict(config["train"]["test_dataloader"]))
    results = run(loader, args.max_batches)
    for name, r in sorted(results.items()):
        print(f"{name:10s} bpd={r['bpd']:.4f}  time={r['seconds']:.2f}s")


if __name__ == "__main__":
    main()
