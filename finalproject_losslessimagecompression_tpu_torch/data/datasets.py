"""Datasets: image folders (PIL), ImageNet64 npz batches, synthetic data.

The port's own copy of the JAX package's `data/datasets.py`, numpy only, so
that both packages draw the same images from the same seeds.  Output is
NHWC float32 in [0, 1], the layout of the port's public model functions.
PIL is imported only inside the image-file datasets.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..registry import DATASETS

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp", ".ppm"}


def _center_crop(img, size: Tuple[int, int]):
    """PIL center crop to (h, w), padding with black if smaller (torchvision
    CenterCrop semantics)."""
    from PIL import Image

    w_img, h_img = img.size
    th, tw = size
    if w_img < tw or h_img < th:
        canvas = Image.new(img.mode, (max(tw, w_img), max(th, h_img)))
        canvas.paste(img, ((canvas.size[0] - w_img) // 2,
                           (canvas.size[1] - h_img) // 2))
        img = canvas
        w_img, h_img = img.size
    left = (w_img - tw) // 2
    top = (h_img - th) // 2
    return img.crop((left, top, left + tw, top + th))


def _to_array(img) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


@DATASETS.register(name="ImageFolder")
class ImageFolderDataset:
    """Recursive image-folder dataset with center-crop + resize."""

    def __init__(self, path: str, resize=None, centercrop=None):
        self.path = path
        self.resize = tuple(resize) if resize else None
        self.centercrop = tuple(centercrop) if centercrop else None
        files: List[str] = []
        for root, _, names in os.walk(path):
            for n in sorted(names):
                if os.path.splitext(n)[1].lower() in _IMG_EXTS:
                    files.append(os.path.join(root, n))
        files.sort()
        if not files:
            raise FileNotFoundError(f"no images under {path}")
        self.files = files

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.files[idx]).convert("RGB")
        if self.centercrop:
            img = _center_crop(img, self.centercrop)
        if self.resize:
            img = img.resize((self.resize[1], self.resize[0]), Image.BILINEAR)
        return _to_array(img)


@DATASETS.register(name="ImageNet64Dataset")
class ImageNet64Dataset:
    """ImageNet64 npz batches: the train split loads
    train_data_batch_{1..10}.npz, the val split val_data.npz; rows are flat
    3x64x64 uint8."""

    def __init__(self, path: str, size=(3, 64, 64), train: bool = True):
        self.size = tuple(size)
        self.datas = []
        self.lens = []
        names = (
            [f"train_data_batch_{i+1}.npz" for i in range(10)]
            if train
            else ["val_data.npz"]
        )
        for name in names:
            fp = os.path.join(path, name)
            if not os.path.exists(fp):
                continue
            arr = np.load(fp)["data"]
            self.datas.append(arr)
            self.lens.append(arr.shape[0])
        if not self.datas:
            raise FileNotFoundError(f"no ImageNet64 npz files under {path}")

    def __len__(self):
        return sum(self.lens)

    def __getitem__(self, idx: int) -> np.ndarray:
        for arr, ln in zip(self.datas, self.lens):
            if idx < ln:
                row = arr[idx]
                break
            idx -= ln
        c, h, w = self.size
        img = row.reshape(c, h, w).transpose(1, 2, 0)  # -> HWC
        return img.astype(np.float32) / 255.0


@DATASETS.register(name="SyntheticImages")
class SyntheticImages:
    """Deterministic synthetic images: box-blurred uniform noise rescaled to
    [0, 1] -- compressible structure without any external data, for tests
    and data-free runs."""

    def __init__(self, size=(32, 32, 3), length: int = 64, seed: int = 0,
                 smooth: int = 3):
        self.size = tuple(size)
        self.length = length
        self.seed = seed
        self.smooth = smooth

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> np.ndarray:
        h, w, c = self.size
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, idx])
        )
        img = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
        k = self.smooth
        if k > 1:  # box-blur via cumulative sums, per axis
            for axis in (0, 1):
                img = np.apply_along_axis(
                    lambda v: np.convolve(v, np.ones(k) / k, mode="same"),
                    axis,
                    img,
                )
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-6)
        return img.astype(np.float32)


@DATASETS.register(name="NaturalSynthetic")
class NaturalSynthetic:
    """Natural-statistics synthetic family: 1/f^alpha power-law fields
    (the canonical second-order statistic of natural images), sharp
    half-plane edges between region means, and occasional oriented
    gratings (texture), with luminance-correlated channels.  Deterministic
    per (seed, idx): a stand-in for photographs where no image data is at
    hand, with a train/held-out split by seed."""

    def __init__(self, size=(64, 64, 3), length: int = 2048, seed: int = 0,
                 alpha_range=(0.9, 1.6), edge_prob: float = 0.7,
                 texture_prob: float = 0.4):
        self.size = tuple(size)
        self.length = length
        self.seed = seed
        self.alpha_range = tuple(alpha_range)
        self.edge_prob = edge_prob
        self.texture_prob = texture_prob

    def __len__(self):
        return self.length

    def _powerlaw(self, rng, h, w, alpha):
        fy = np.fft.fftfreq(h)[:, None]
        fx = np.fft.fftfreq(w)[None, :]
        f = np.sqrt(fy * fy + fx * fx)
        f[0, 0] = 1.0  # kill DC scaling (mean handled separately)
        amp = f ** (-alpha)
        amp[0, 0] = 0.0
        phase = np.exp(2j * np.pi * rng.uniform(size=(h, w)))
        field = np.fft.ifft2(amp * phase).real
        s = field.std()
        return field / (s if s > 1e-12 else 1.0)

    def __getitem__(self, idx: int) -> np.ndarray:
        h, w, c = self.size
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, idx])
        )
        alpha = rng.uniform(*self.alpha_range)
        # luminance field shared by all channels + weaker independent
        # chroma fields (natural images are strongly luminance-correlated)
        luma = self._powerlaw(rng, h, w, alpha)
        img = np.stack(
            [
                luma + 0.3 * self._powerlaw(rng, h, w, alpha)
                for _ in range(c)
            ],
            axis=-1,
        )
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        # half-plane edges: step changes in region mean (occlusion
        # boundaries -- the heavy-tailed gradient statistic)
        if rng.uniform() < self.edge_prob:
            for _ in range(rng.integers(1, 4)):
                th = rng.uniform(0, np.pi)
                off = rng.uniform(0.2, 0.8)
                side = (
                    (xx / w) * np.cos(th) + (yy / h) * np.sin(th) > off
                )
                img += side[:, :, None] * rng.uniform(-1.2, 1.2, (c,))
        # oriented grating in a band (texture)
        if rng.uniform() < self.texture_prob:
            th = rng.uniform(0, np.pi)
            freq = rng.uniform(2.0, 8.0)
            grating = np.sin(
                2 * np.pi * freq
                * ((xx / w) * np.cos(th) + (yy / h) * np.sin(th))
            )
            img += 0.25 * grating[:, :, None]
        # robust [0, 1] mapping: center on the mean, scale by 3 sigma
        img = 0.5 + (img - img.mean()) / (6.0 * max(img.std(), 1e-6))
        return np.clip(img, 0.0, 1.0).astype(np.float32)


class CachedDataset:
    """Memoizing view over any dataset: each item is decoded/generated once
    and then served from a preallocated float32 array, so the step loop
    does not wait on PIL decodes or synthetic generation after the first
    epoch.  Values are bit-identical to the uncached dataset."""

    def __init__(self, inner):
        self.inner = inner
        self._cache = None
        self._have = np.zeros(len(inner), bool)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is None:
            first = np.asarray(self.inner[idx], np.float32)
            self._cache = np.empty((len(self.inner),) + first.shape,
                                   np.float32)
            self._cache[idx] = first
            self._have[idx] = True
            return first
        if not self._have[idx]:
            self._cache[idx] = self.inner[idx]
            self._have[idx] = True
        return self._cache[idx]


@DATASETS.register(name="RandomScaledCelebA")
@DATASETS.register(name="RandomScaledImages")
class RandomScaledImages:
    """Random-scale center crop (scale in [0.7, 1], seeded per (seed, idx))
    resized to `size` (C, H, W)."""

    def __init__(self, path: str, size=(3, 215, 178), seed: int = 0):
        self.inner = ImageFolderDataset(path)
        self.size = tuple(size)
        self.seed = seed

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx: int) -> np.ndarray:
        from PIL import Image

        rng = np.random.default_rng(np.random.SeedSequence([self.seed, idx]))
        img = Image.open(self.inner.files[idx]).convert("RGB")
        r = rng.uniform(0.7, 1.0)
        _, h, w = self.size
        img = _center_crop(img, (int(r * h), int(r * w)))
        img = img.resize((w, h), Image.BILINEAR)
        return _to_array(img)
