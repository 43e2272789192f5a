"""Inputs and weights made from the run's seed.

`natural_images` is a frozen copy of the package's `NaturalSynthetic`
family (1/f^alpha power-law fields, half-plane edges, oriented gratings,
luminance-correlated channels), deterministic per (seed, index): the
stand-in for photographs, since no image data ships with the repository.
Images are rounded to the 1/256 grid, as the package's loaders hand
them to a codec or a train step.

`seeded_weights` fills a state_dict of given names and shapes on the
device from one torch.Generator on that device, in one call: convolution
kernels N(0, 1/fan_in) (lecun scale), biases N(0, BIAS_SD^2), every
DenseBlock's 1x1 projection N(0, PROJ_SD^2), a VQ codebook
N(0, CODEBOOK_SD^2).  A freshly initialised projection is zero, which
would make every coupling shift and every prior trivial; these weights
make both do real work.  Each model of a configuration draws from its own
stream of the seed.  The same dict goes to the program and to the
reference.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

PROJ_SD = 0.01
BIAS_SD = 0.01
CODEBOOK_SD = 0.5  # about the spread of the encoder's tanh outputs


def _powerlaw(rng, h: int, w: int, alpha: float) -> np.ndarray:
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = f ** (-alpha)
    amp[0, 0] = 0.0
    phase = np.exp(2j * np.pi * rng.uniform(size=(h, w)))
    field = np.fft.ifft2(amp * phase).real
    s = field.std()
    return field / (s if s > 1e-12 else 1.0)


def natural_image(seed: int, idx: int, size: Tuple[int, int, int]):
    """One image in [0, 1], float32 [h, w, c]."""
    h, w, c = size
    rng = np.random.default_rng(np.random.SeedSequence([seed, idx]))
    alpha = rng.uniform(0.9, 1.6)
    luma = _powerlaw(rng, h, w, alpha)
    img = np.stack([luma + 0.3 * _powerlaw(rng, h, w, alpha)
                    for _ in range(c)], axis=-1)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if rng.uniform() < 0.7:
        for _ in range(rng.integers(1, 4)):
            th = rng.uniform(0, np.pi)
            off = rng.uniform(0.2, 0.8)
            side = (xx / w) * np.cos(th) + (yy / h) * np.sin(th) > off
            img += side[:, :, None] * rng.uniform(-1.2, 1.2, (c,))
    if rng.uniform() < 0.4:
        th = rng.uniform(0, np.pi)
        freq = rng.uniform(2.0, 8.0)
        grating = np.sin(2 * np.pi * freq * ((xx / w) * np.cos(th)
                                             + (yy / h) * np.sin(th)))
        img += 0.25 * grating[:, :, None]
    img = 0.5 + (img - img.mean()) / (6.0 * max(img.std(), 1e-6))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def natural_images(seed: int, start: int, count: int,
                   size: Tuple[int, int, int]) -> np.ndarray:
    """Images start .. start + count - 1 of the seed's family on the 1/256
    grid: float32 [count, h, w, c]."""
    out = np.empty((count,) + tuple(size), np.float32)
    for i in range(count):
        out[i] = np.round(natural_image(seed, start + i, size) * 256.0)
    return out / np.float32(256.0)


def _sd(name: str, shape) -> float:
    if ".proj." in name:
        return PROJ_SD
    if name.endswith("codebook"):
        return CODEBOOK_SD
    if len(shape) == 1:
        return BIAS_SD
    if "deconvs." in name:  # a transposed conv's kernel is [in, out, k, k]
        return float(shape[0] * np.prod(shape[2:])) ** -0.5
    return float(np.prod(shape[1:])) ** -0.5


def seeded_weights(shapes: Dict[str, Sequence[int]], seed: int, device,
                   stream: int = 0) -> Dict[str, torch.Tensor]:
    """A state_dict of the given names and shapes, drawn on `device` from
    the seed's stream `stream`."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    key = np.random.SeedSequence([int(seed), stream]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(key))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, pos = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat[pos:pos + n].view(*shape).mul_(_sd(name, shape))
        pos += n
    return out
