"""Metrics: JSONL scalars, TensorBoard where it imports, PNG image grids
where PIL imports.

JSONL is the primary sink, one record per scalar with the JAX package's
fields ({"tag", "value", "step", "time"}) and tags, so one reader serves
both packages' logs.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except ImportError:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_image_grid(
        self, tag: str, images: np.ndarray, step: int, nrow: int = 4
    ) -> None:
        """images: [N, H, W, C] in [0, 1]; tiled into a grid PNG (skipped
        where PIL does not import)."""
        try:
            from PIL import Image
        except ImportError:
            return
        images = np.clip(np.asarray(images), 0.0, 1.0)
        n, h, w, c = images.shape
        ncol = nrow
        nrows = -(-n // ncol)
        grid = np.zeros((nrows * h, ncol * w, c), images.dtype)
        for i in range(n):
            r, cidx = divmod(i, ncol)
            grid[r * h : (r + 1) * h, cidx * w : (cidx + 1) * w] = images[i]
        arr = (grid * 255).astype(np.uint8)
        if c == 1:
            arr = arr[..., 0]
        img_dir = os.path.join(self.log_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        safe = tag.replace("/", "_").replace(" ", "_").replace("=", "")
        Image.fromarray(arr).save(
            os.path.join(img_dir, f"{safe}_{step:08d}.png")
        )

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """A MetricsWriter that writes nothing: a sharded run's ranks other
    than 0, whose metrics equal rank 0's."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def add_image_grid(self, tag: str, images, step: int,
                       nrow: int = 4) -> None:
        pass

    def close(self) -> None:
        pass
