"""The DenseBlock's buffer path (`ops.dense_conv`, `layers.DenseBlock`) on
the CPU: its plain version against the concatenation path, the boundary
bias field, the choice between the two paths, the split count, a CUDA call
without the kernels' library, and a codec round trip through the buffer
path.  The kernel itself runs only on the card (`chip_smoke.py --dense`).
"""

import numpy as np
import pytest
import torch

from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch.models import layers
from finalproject_losslessimagecompression_tpu_torch.models.config import (
    DenseBlockCfg,
)
from finalproject_losslessimagecompression_tpu_torch.ops import dense_conv

torch.set_num_threads(2)  # the suite runs several workers at once


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to reach the code a
    CUDA tensor takes (its operations keep the subclass)."""

    @property
    def is_cuda(self):
        return True


def _block(in_ch, out, growth, depth, act, seed=1, **kw):
    """A DenseBlock with every bias and the projection drawn off zero, so
    the boundary bias field and the output are not trivial."""
    blk = layers.DenseBlock(in_ch, out,
                            DenseBlockCfg(growth, depth, act, **kw),
                            gen=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for layer in blk.layers:
            layer.conv1_bias.copy_(torch.randn(layer.conv1_bias.shape,
                                               generator=g))
            layer.conv3_bias.copy_(torch.randn(layer.conv3_bias.shape,
                                               generator=g))
        blk.proj.weight.copy_(0.1 * torch.randn(blk.proj.weight.shape,
                                                generator=g))
        blk.proj.bias.copy_(torch.randn(blk.proj.bias.shape, generator=g))
    return blk


# reduced widths of the published layers: imagenet64's couplings (in_ch 9
# at level 0, growth 43 a layer of 512 / 12) and priors (ReLU), the
# conditional flow's couplings (growth 48 a layer of 384 / 8, LeakyReLU);
# one image row or column puts every pixel on an edge
BLOCKS = [
    ("ReLU", 9, 3, 86, 2, 6, 10),
    ("ReLU", 24, 12, 43, 1, 4, 4),
    ("LeakyReLU", 12, 4, 96, 2, 5, 8),
    ("LeakyReLU", 6, 2, 48, 1, 1, 9),
    ("ReLU", 5, 3, 20, 2, 7, 1),
]


@pytest.mark.parametrize("act,in_ch,out,growth,depth,h,w", BLOCKS)
def test_buffer_path_equals_concat_path(act, in_ch, out, growth, depth, h,
                                        w):
    """The buffer path (the plain version of the kernel writing each layer
    into one NHWC buffer, the projection one matrix product) equals the
    concatenation path at float32 rounding, and gives the same bits for a
    non-contiguous view of the same input.  Tolerance: 2e-5 of the
    output's largest magnitude (sums taken in another order)."""
    blk = _block(in_ch, out, growth, depth, act)
    x = torch.randn((2, h, w, in_ch),
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = blk.nhwc(x)
        got = blk.grow_in_place(x)
        strided = blk.grow_in_place(
            x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    tol = 2e-5 * float(want.abs().max())
    assert got.shape == want.shape == (2, h, w, out)
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, strided)


@pytest.mark.parametrize("slope", [0.0, 0.01])
def test_bias_field_at_edges(slope):
    """With a zero input, a layer's output is act(T): T[y, x, n] = b3[n] +
    the sum of bias_a[n, t] over the taps t whose input pixel is inside
    the image, here counted tap by tap in numpy at every pixel of a 4 x 5
    image (corners, edges and the inside).  The buffer's other channels
    stay as they were.  Tolerance: 1e-6 (nine-term float32 sums)."""
    h, w, cin, g = 4, 5, 3, 6
    rng = np.random.default_rng(5)
    bias_a = rng.normal(size=(g, 9)).astype(np.float32)
    b3 = rng.normal(size=g).astype(np.float32)
    buf = torch.full((1, h, w, 12), float("nan"))
    buf[..., :cin] = 0.0
    dense_conv.dense_conv3x3(buf, cin, torch.randn(9, cin, g),
                             torch.from_numpy(bias_a), torch.from_numpy(b3),
                             slope)
    want = np.empty((h, w, g), np.float32)
    for y in range(h):
        for x in range(w):
            taps = [ky * 3 + kx for ky in range(3) for kx in range(3)
                    if 0 <= y + ky - 1 < h and 0 <= x + kx - 1 < w]
            v = b3 + bias_a[:, taps].sum(axis=1)
            want[y, x] = np.maximum(v, 0) + slope * np.minimum(v, 0)
    np.testing.assert_allclose(buf[0, ..., cin:cin + g].numpy(), want,
                               atol=1e-6)
    assert bool(buf[..., cin + g:].isnan().all())
    assert torch.equal(buf[..., :cin], torch.zeros(1, h, w, cin))


def _grad_off(blk, x):
    with torch.no_grad():
        return blk.grows_in_place(x)


def _grad_on(blk, x):
    return blk.grows_in_place(x)


def _frozen(blk, x):
    for p in blk.parameters():
        p.requires_grad_(False)
    return blk.grows_in_place(x)


def _input_grad(blk, x):
    for p in blk.parameters():
        p.requires_grad_(False)
    return blk.grows_in_place(x.detach().requires_grad_(True))


@pytest.mark.parametrize("kw,card,call,want", [
    ({}, True, _grad_off, True),
    ({}, True, _frozen, True),
    ({}, True, _grad_on, False),
    ({}, True, _input_grad, False),
    ({}, False, _grad_off, False),
    ({"dtype": "bfloat16"}, True, _grad_off, False),
    ({"fuse_1x1": False}, True, _grad_off, False),
    ({"act": "Tanh"}, True, _grad_off, False),
])
def test_path_choice(kw, card, call, want):
    """The buffer path where nothing can need a backward (autograd off, or
    neither input nor parameter requiring grad) on a float32 CUDA tensor of
    a float32 fused ReLU / LeakyReLU block; the concatenation path for
    training, a bfloat16 or unfused block, another activation, a CPU
    tensor."""
    cfg = dict(kw)
    act = cfg.pop("act", "ReLU")
    blk = layers.DenseBlock(4, 2, DenseBlockCfg(8, 2, act, **cfg))
    x = torch.zeros(1, 3, 3, 4)
    assert call(blk, x.as_subclass(_OnCard) if card else x) is want


def test_cuda_call_without_library_raises(monkeypatch):
    """A CUDA buffer whose kernels' library cannot be built raises, from
    the wrapper and from a DenseBlock on its buffer path: neither falls
    back to the plain version or the concatenation path, and no launch is
    counted."""
    def absent():
        raise RuntimeError("nvcc not found: the DenseLayer kernel cannot "
                           "be built")

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(dense_conv, "_lib", None)
    monkeypatch.setattr(dense_conv, "build", absent)
    monkeypatch.setattr(dense_conv, "dense_conv3x3_plain", plain)
    monkeypatch.setattr(layers.DenseBlock, "concatenate", plain)
    launches = dense_conv.dense_conv3x3.launches
    buf = torch.zeros(1, 2, 2, 8).as_subclass(_OnCard)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dense_conv.dense_conv3x3(buf, 2, torch.zeros(9, 2, 3),
                                 torch.zeros(3, 9), torch.zeros(3), 0.0)
    blk = layers.DenseBlock(2, 2, DenseBlockCfg(6, 2, "ReLU"))
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc not found"):
        blk.nhwc(torch.zeros(1, 2, 2, 2).as_subclass(_OnCard))
    assert dense_conv.dense_conv3x3.launches == launches


@pytest.mark.parametrize("rows,width,cin,g,want", [
    (512, 32, 9, 43, 2),     # imagenet64 level 0 at batch 16, first layer
    (512, 32, 478, 43, 4),   # its last layer
    (256, 16, 478, 43, 16),  # level 1
    (128, 8, 478, 43, 60),   # level 2
    (32, 8, 400, 48, 50),    # a request's level 2 (batch 4)
    (1, 1, 3, 100, 1),       # two channel tiles, one 8-channel stage group
])
def test_split_count(rows, width, cin, g, want):
    """The split over K is a function of the launch shape (and the card's
    132 SMs) alone: one wave of two blocks an SM, at most one split per 8
    input channels, at least one (the wide geometry's rule; the last case,
    one pixel wide, takes the narrow one, where 3 input channels make one
    split as well)."""
    assert dense_conv.geometry(rows, width, cin, g, 132).splits == want


# (rows = N * H, width, cin, g) -> (row_w, tile_n, splits, blocks) on 132
# SMs: 264 resident blocks of two an SM
@pytest.mark.parametrize("rows,width,cin,g,want", [
    # imagenet64 at batch 16 and resflow-cond at 4: the wide geometry, the
    # splits of test_split_count
    (512, 32, 478, 43, (0, 48, 4, 256)),
    (256, 16, 478, 43, (0, 48, 16, 256)),
    (128, 8, 478, 43, (0, 48, 60, 240)),
    (32, 8, 400, 48, (0, 48, 50, 50)),
    # the two-level rough sub-flow, 4 x 27 x 23: wide, two 48-channel tiles
    (108, 23, 2, 64, (0, 48, 1, 22)),
    (108, 23, 450, 64, (0, 48, 12, 264)),
    # widths below 8 that do not divide it stay wide
    (10, 3, 16, 8, (0, 48, 2, 2)),
    (10, 6, 16, 8, (0, 48, 2, 2)),
    # the fine sub-flow, 2484 x 4 x 4: narrow, one 64-channel tile
    (9936, 4, 9, 64, (4, 64, 1, 156)),
    (9936, 4, 73, 64, (4, 64, 3, 468)),
    (9936, 4, 457, 64, (4, 64, 5, 780)),
    # W 2 with g <= 48 (the 48-channel tile), W 1, an odd H (segments of
    # two 4-wide rows across images of 5 rows), g over one 64-channel tile
    (384, 2, 37, 43, (2, 48, 2, 6)),
    (112, 1, 20, 64, (1, 64, 1, 1)),
    (45, 4, 50, 64, (4, 64, 3, 3)),
    (99, 4, 100, 100, (4, 64, 6, 24)),
])
def test_geometry(rows, width, cin, g, want):
    """The kernel's geometry is a function of the launch shape and the
    card's SMs alone: narrow where the width divides a segment of 8 (whole
    rows a segment, a 64-channel tile where g > 48), else the wide
    geometry with its one-wave split rule."""
    geo = dense_conv.geometry(rows, width, cin, g, 132)
    assert tuple(geo) == want
    assert geo == dense_conv.geometry(rows, width, cin, g, 132)


@pytest.mark.parametrize("cin", [c0 + 64 * k for c0 in (9, 12)
                                 for k in range(8)])
def test_fine_tiles_fill_the_card(cin):
    """Every launch of the two-level fine sub-flow (2484 tiles of 4 x 4 at
    batch 4, the couplings' cin 9 + 64 k and the prior's 12 + 64 k, g 64)
    takes the narrow geometry with one 64-channel tile, and from a block's
    second layer on at least one whole wave of two blocks on each of 132
    SMs, at most three.  A block's first layer (cin 9, 12) keeps one split:
    a split holds at least 16 channels."""
    geo = dense_conv.geometry(2484 * 4, 4, cin, 64, 132)
    assert (geo.row_w, geo.tile_n) == (4, 64)
    assert geo.blocks == 156 * geo.splits
    if cin > 64:
        assert 264 <= geo.blocks <= 3 * 264
    else:
        assert geo.splits == 1


class _FakeLib:
    """Stands in for the kernels' library: records each launch's integer
    arguments and returns `err`."""

    def __init__(self, err=0):
        self.err = err
        self.fprop, self.reduce = [], []

    def dense_conv3x3_launch(self, *args):
        # M, H, W, P, cin, g, row_w, tile_n, splits
        self.fprop.append(args[5:14])
        return self.err

    def dense_conv3x3_reduce_launch(self, *args):
        # M, H, W, P, cin, g, tile_n, splits
        self.reduce.append(args[4:12])
        return self.err


def _on_card(monkeypatch, lib):
    """Route the wrapper's CUDA path to `lib` on CPU tensors."""
    monkeypatch.setattr(dense_conv, "_load", lambda: lib)
    monkeypatch.setattr(dense_conv, "_sms", lambda index: 132)
    monkeypatch.setattr(dense_conv, "stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)


def _layer(shape, cin, g, card=True, seed=0):
    """A buffer of `shape` and a layer's operands (the buffer on the card
    where `card`)."""
    gen = torch.Generator().manual_seed(seed)
    buf = torch.randn(shape, generator=gen)
    return (buf.as_subclass(_OnCard) if card else buf, cin,
            torch.randn((9, cin, g), generator=gen),
            torch.randn((g, 9), generator=gen), torch.randn((g,),
                                                            generator=gen))


def _counts():
    return (dense_conv.dense_conv3x3.launches,
            dense_conv.dense_conv3x3.narrow_launches,
            dense_conv.splitk_reduce.launches)


def test_wrapper_launches_the_geometry(monkeypatch):
    """A call hands the kernel `geometry`'s row width, tile and splits for
    its launch shape, whatever the buffer holds; a narrow launch counts on
    `dense_conv3x3.narrow_launches` besides `launches`, a split one on
    `splitk_reduce.launches`.  Inside `record_launches` the launches go to
    the capture's tally instead, and each replay of the counted graph adds
    them."""
    from finalproject_losslessimagecompression_tpu_torch.utils import graphs

    lib = _FakeLib()
    _on_card(monkeypatch, lib)
    narrow = (6, 4, 4, 80), 70, 8    # 1 tile, 70 channels: 4 splits
    wide = (1, 8, 8, 16), 4, 8
    c0 = _counts()
    for shape, cin, g in (narrow, narrow, wide):
        dense_conv.dense_conv3x3(*_layer(shape, cin, g, seed=len(lib.fprop)),
                                 0.0)
        n, h, w, p = shape
        geo = dense_conv.geometry(n * h, w, cin, g, 132)
        assert lib.fprop[-1] == (n * h * w, h, w, p, cin, g, geo.row_w,
                                 geo.tile_n, geo.splits)
    assert lib.fprop[0] == lib.fprop[1]
    assert lib.fprop[0][6:] == (4, 48, 4) and lib.fprop[2][6:] == (0, 48, 1)
    assert lib.reduce == [(96, 4, 4, 80, 70, 8, 48, 4)] * 2
    assert tuple(a - b for a, b in zip(_counts(), c0)) == (3, 2, 2)

    c1 = _counts()
    with graphs.record_launches() as tally:
        dense_conv.dense_conv3x3(*_layer(*narrow), 0.0)
    assert tally == {dense_conv.dense_conv3x3: 1,
                     (dense_conv.dense_conv3x3, "narrow_launches"): 1,
                     dense_conv.splitk_reduce: 1}
    assert _counts() == c1
    graph = graphs.CountedGraph(type("Stub", (), {
        "replay": lambda self: None})(), tally)
    graph.replay()
    graph.replay()
    assert tuple(a - b for a, b in zip(_counts(), c1)) == (2, 2, 2)


def _absent():
    raise RuntimeError("nvcc not found: the DenseLayer kernel cannot be "
                       "built")


@pytest.mark.parametrize("case", ["cpu", "no_library", "launch_refused"])
def test_narrow_counter_counts_no_cpu_or_failed_call(monkeypatch, case):
    """A narrow-shaped call on a CPU buffer (the plain version), one whose
    library cannot be built and one whose launch the library refuses count
    nothing on `narrow_launches`, `launches` or the reduce's counter."""
    shape, cin, g = (6, 4, 4, 80), 70, 8
    if case == "no_library":
        monkeypatch.setattr(dense_conv, "_lib", None)
        monkeypatch.setattr(dense_conv, "build", _absent)
    else:
        _on_card(monkeypatch, _FakeLib(err=1))
    c0 = _counts()
    if case == "cpu":
        dense_conv.dense_conv3x3(*_layer(shape, cin, g, card=False), 0.0)
    else:
        with pytest.raises(RuntimeError, match="nvcc not found|launch "
                           "failed"):
            dense_conv.dense_conv3x3(*_layer(shape, cin, g), 0.0)
    assert _counts() == c0


def test_codec_round_trip_through_buffer_path(monkeypatch):
    """A small FlowCodec whose every DenseBlock takes the buffer path (its
    device check bypassed, so the plain version runs) codes and decodes
    images exactly; every layer went through `dense_conv3x3`."""
    calls = []
    plain = dense_conv.dense_conv3x3_plain

    def counted(*args):
        calls.append(args[1])
        plain(*args)

    monkeypatch.setattr(dense_conv, "dense_conv3x3_plain", counted)
    monkeypatch.setattr(layers.DenseBlock, "grows_in_place",
                        lambda self, x: self.kernel_fits
                        and not torch.is_grad_enabled())
    nn = DenseBlockCfg(8, 2, "LeakyReLU")
    cfg = TM.FlowCfg(H=16, W=16, C=3, nflows=1, nsplit=2,
                     couple=TM.CouplingCfg(0.75, nn), prior_nn=nn)
    model = TM.IDFlow(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".proj." in name:
                p.add_(0.01 * torch.randn(p.shape, generator=g))
    rng = np.random.default_rng(6)
    x = (np.round(rng.uniform(0, 1, (2, 16, 16, 3)) * 256) / 256).astype(
        np.float32)
    codec = TM.FlowCodec(model)
    blobs, info = codec.compress(torch.from_numpy(x))
    n_encode = len(calls)
    got = codec.decompress(blobs, info)
    assert np.array_equal(np.asarray(got), x)
    # 2 layers x (1 coupling + 1 prior) x 2 levels, each direction
    assert n_encode == len(calls) - n_encode == 8
