"""The fused DenseLayer's 3x3 convolution on a DenseBlock's growing buffer
(csrc/dense_conv.cu): build, binding, wrapper and plain version.

`dense_conv3x3(buf, cin, w, bias_a, b3, slope)` computes one fused
DenseLayer in place: from the channel prefix [0, cin) of the NHWC buffer
`buf` [N, H, W, P] it writes the layer's g new channels at [cin, cin + g):

    act(conv3x3(x, w, zero padding) + T),  T[y, x, n] = b3[n] + the sum of
    bias_a[n, t] over the taps t whose input pixel is inside the image

with w [9, cin, g] = W1 . W3 (tap-major), bias_a [g, 9] = W3 . b1 and
act(v) = max(v, 0) + slope * min(v, 0) (ReLU: slope 0; LeakyReLU: 0.01).

It replaces no Pallas kernel: the JAX package leaves this convolution to
XLA, as this package's training path leaves it to cuDNN
(`DenseBlock.concatenate`).  What bounds it on an H100: float32 FMA on the
SIMT cores (67 TFLOP/s; TF32 is off for the codec), FMAs spent on masked
pixels and channels, and few outputs per layer (M = N*H*W pixels by 42-64
channels) to spread over 132 SMs.  A thread keeps a segment of 8 pixels by
a quarter of the block's output channels in registers and multiplies each
row it loads into all three horizontal taps; stages of (8 channels, one
tap row) of the K dimension go through a cp.async ring in shared memory.
`geometry`, a function of the launch shape alone, picks one of two shapes
of the one kernel:

- wide (W >= 8, or W not dividing 8): a segment is 8 pixels of one image
  row, loaded with its halo (the last segment of a row masked), the block
  tile 32 segments by 48 channels; K is split over several blocks per tile
  where M is small, up to one wave of BLOCKS_PER_SM blocks an SM.
- narrow (W in 1, 2, 4): a segment is 8 / W whole rows of the stacked
  N*H rows, so no pixel is masked, and the taps that would read the zero
  padding beside a row are skipped (10 of 12 at W = 4).  The block tile is
  64 channels where g > 48, so the two-level codec's g = 64 is one tile with
  no masked channel.  K is split so that the blocks fill the card's waves
  best (`narrow_splits`).

Each split writes a partial tile, and a second kernel,
`dense_conv3x3_splitk_reduce_kernel`, sums them in split order and applies
the epilogue.  No atomics, so a shape gives the same bits on every launch:
what keeps the codec's compress and decompress bit-exact.

Dispatch is by device: a CUDA buffer launches the kernel (or raises), a CPU
buffer runs `dense_conv3x3_plain`, which computes the same function with
`F.conv2d` writing into the slice.  Launch counts: `dense_conv3x3.launches`
(one a layer), `dense_conv3x3.narrow_launches` (one a layer that takes the
narrow geometry) and `splitk_reduce.launches` (one a layer whose K is
split), tallied into a CUDA graph's capture inside
`utils.graphs.record_launches` and added on every replay, as the rANS
wrappers' are.

The library is built with nvcc at first use into the package's `build/`
directory (`native.build_native`) and bound with ctypes.  A failed build or
launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..codec.native import (
    CSRC_DIR,
    build_native,
    check_launch,
    find_nvcc,
    stream,
)
from ..utils.graphs import count_launch

_SRC = os.path.join(CSRC_DIR, "dense_conv.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# the kernel's segment (kSegPx), segments of a block tile (kSegs), output
# channels of a wide block tile (kWideBN) and of a narrow one where g > 48,
# and input channels of a stage (kKC)
SEG_PX, TILE_SEGS, TILE_N, NARROW_TILE_N, STAGE_CH = 8, 32, 48, 64, 8
TAPS = 9
# blocks the kernel keeps resident on an SM (its __launch_bounds__)
BLOCKS_PER_SM = 2
# a narrow layer's splits: at least NARROW_SPLIT_CH input channels each,
# and at most NARROW_WAVES waves of blocks in all, since each split's
# partial tile costs a write and a read of M x tile_n floats (on the
# two-level codec's 4x4 tiles, 3 splits of cin 73 beat 1 and 5, and 5
# splits of cin 201-460, 3 waves, beat 4 and 6-12)
NARROW_SPLIT_CH, NARROW_WAVES = 16, 3


class Geometry(NamedTuple):
    """A launch's shape of the kernel: `row_w` 0 (wide) or W (narrow), the
    block's output channels, the splits of K, and the blocks launched."""
    row_w: int
    tile_n: int
    splits: int
    blocks: int


_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile the kernels (once per source hash) and return the .so path."""
    return build_native(_SRC, find_nvcc(), NVCC_FLAGS, "dense_conv")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.dense_conv3x3_launch.restype = i
            lib.dense_conv3x3_launch.argtypes = [p] * 5 + [i] * 9 + [f32, p]
            lib.dense_conv3x3_reduce_launch.restype = i
            lib.dense_conv3x3_reduce_launch.argtypes = (
                [p] * 4 + [i] * 8 + [f32, p])
            _lib = lib
    return _lib


def geometry(rows: int, width: int, cin: int, g: int,
             sms: int) -> Geometry:
    """The kernel's geometry for a layer over `rows` = N * H image rows of
    `width` pixels, cin -> g channels, on a card of `sms` SMs (module
    docstring): narrow where the width divides a segment."""
    narrow = width < SEG_PX and SEG_PX % width == 0
    if narrow:
        segments = -(-rows * width // SEG_PX)
        tile_n = NARROW_TILE_N if g > TILE_N else TILE_N
    else:
        segments = rows * -(-width // SEG_PX)
        tile_n = TILE_N
    tiles = -(-segments // TILE_SEGS) * -(-g // tile_n)
    slots = BLOCKS_PER_SM * sms
    if narrow:
        splits = narrow_splits(tiles, cin, slots)
    else:
        # one wave, at most one split per 8 input channels
        splits = max(1, min(slots // tiles, -(-cin // STAGE_CH)))
    return Geometry(width if narrow else 0, tile_n, splits, tiles * splits)


def narrow_splits(tiles: int, cin: int, slots: int) -> int:
    """The splits of K for `tiles` narrow block tiles on `slots` resident
    blocks: the fewest that give the least time in waves, ceil(tiles *
    splits / slots) / splits, among those with at least NARROW_SPLIT_CH
    input channels a split and at most NARROW_WAVES waves."""
    most = max(1, min(cin // NARROW_SPLIT_CH,
                      NARROW_WAVES * slots // tiles))
    return min(range(1, most + 1),
               key=lambda s: (-(-tiles * s // slots) / s, s))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _operands(buf, cin, w, bias_a, b3):
    """(M, H, W, P, g) of a call; raises on what the kernel does not take."""
    if buf.dim() != 4:
        raise ValueError(f"buf: expected [N, H, W, P], got {tuple(buf.shape)}")
    n, h, wd, p = buf.shape
    g = w.shape[-1]
    if not (0 < cin and cin + g <= p):
        raise ValueError(f"layer channels [0, {cin}) + {g} exceed pitch {p}")
    for t, name, shape in ((w, "w", (TAPS, cin, g)),
                           (bias_a, "bias_a", (g, TAPS)), (b3, "b3", (g,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
    return n * h * wd, h, wd, p, g


def dense_conv3x3(buf: torch.Tensor, cin: int, w: torch.Tensor,
                  bias_a: torch.Tensor, b3: torch.Tensor,
                  slope: float) -> None:
    """One fused DenseLayer in place (module docstring): reads channels
    [0, cin) of the NHWC float32 buffer `buf`, writes [cin, cin + g)."""
    if not buf.is_cuda:
        return dense_conv3x3_plain(buf, cin, w, bias_a, b3, slope)
    lib = _load()
    m, h, wd, p, g = _operands(buf, cin, w, bias_a, b3)
    dev = buf.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"buf on {dev}, current device "
                         f"{torch.cuda.current_device()}")
    for t, name in ((buf, "buf"), (w, "w"), (bias_a, "bias_a"), (b3, "b3")):
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"{name}: expected float32 on {dev}, got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if p % 4 or buf.data_ptr() % 16:
        raise ValueError("buf: the pitch must be a multiple of 4 floats and "
                         "the data 16-byte aligned")
    geo = geometry(m // wd, wd, cin, g, _sms(dev.index))
    part = buf.new_empty(
        (geo.splits, m, -(-g // geo.tile_n) * geo.tile_n)
        if geo.splits > 1 else (0,))
    err = lib.dense_conv3x3_launch(
        buf.data_ptr(), w.data_ptr(), bias_a.data_ptr(), b3.data_ptr(),
        part.data_ptr(), m, h, wd, p, cin, g, geo.row_w, geo.tile_n,
        geo.splits, slope, stream())
    check_launch(err, "dense_conv3x3_fprop_kernel")
    count_launch(dense_conv3x3)
    if geo.row_w:
        count_launch(dense_conv3x3, "narrow_launches")
    if geo.splits > 1:
        splitk_reduce(lib, buf, part, bias_a, b3,
                      (m, h, wd, p, cin, g, geo.tile_n), geo.splits, slope)


def splitk_reduce(lib, buf, part, bias_a, b3, shape, splits, slope) -> None:
    """Launch the reduce of a split call's partials (its own counter)."""
    err = lib.dense_conv3x3_reduce_launch(
        buf.data_ptr(), part.data_ptr(), bias_a.data_ptr(), b3.data_ptr(),
        *shape, splits, slope, stream())
    check_launch(err, "dense_conv3x3_splitk_reduce_kernel")
    count_launch(splitk_reduce)


# launch counts: each wrapper adds one where it launches its kernel (or to
# the tally of a capture in progress), and nowhere else
dense_conv3x3.launches = 0
dense_conv3x3.narrow_launches = 0
splitk_reduce.launches = 0


def dense_conv3x3_plain(buf: torch.Tensor, cin: int, w: torch.Tensor,
                        bias_a: torch.Tensor, b3: torch.Tensor,
                        slope: float) -> None:
    """`dense_conv3x3` in plain PyTorch, on any device: `F.conv2d` over the
    buffer's prefix, the bias field from the taps' in-bounds masks, written
    into the layer's slice of the buffer."""
    _, h, wd, _, g = _operands(buf, cin, w, bias_a, b3)
    x = buf[..., :cin].permute(0, 3, 1, 2)
    kernel = w.reshape(3, 3, cin, g).permute(3, 2, 0, 1)
    y = F.conv2d(x, kernel, padding=1)
    rows = torch.arange(h, device=buf.device) + torch.arange(
        -1, 2, device=buf.device)[:, None]
    cols = torch.arange(wd, device=buf.device) + torch.arange(
        -1, 2, device=buf.device)[:, None]
    inside = (((rows >= 0) & (rows < h))[:, None, :, None]
              & ((cols >= 0) & (cols < wd))[None, :, None, :])  # [3,3,H,W]
    field = torch.einsum("tyx,gt->gyx",
                         inside.reshape(TAPS, h, wd).to(y.dtype), bias_a)
    v = y + (field + b3[:, None, None])
    out = torch.clamp(v, min=0) + slope * torch.clamp(v, max=0)
    buf[..., cin:cin + g] = out.permute(0, 2, 3, 1)
