"""The port's two-level pyramid codec against the benchmark's plain
reference (`lic_bench/reference/twolevel.py`) on seeded weights, at a tiny
geometry: 30x22 images padded to 32x24, a rough flow over 4x3, a fine
flow over 8x8 tiles (12 of them an image), two flows, DenseBlocks of
growth 8 and depth 2.  CPU only, a few seconds."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from finalproject_losslessimagecompression_tpu_torch.models.twolevel import (
    TwoLevelCfg,
    TwoLevelFlow,
)
from finalproject_losslessimagecompression_tpu_torch.models.twolevel_codec import (  # noqa: E501
    TwoLevelCodec,
)
from finalproject_losslessimagecompression_tpu_torch.utils.profiling import (
    PhaseTimer,
)
from lic_bench import harness
from lic_bench.data import seeded_weights
from lic_bench.judge import codec_numbers
from lic_bench.reference import rans
from lic_bench.reference.flow import Flow
from lic_bench.reference.twolevel import TwoLevel, shapes
from lic_bench.tests.tiny_twolevel import tiny_twolevel_model

# the MKL VML warm-up the port's test files share (ROADMAP section 3)
torch.exp(torch.zeros(1 << 16))

SEED = 2 ** 31 + 11
MODEL = tiny_twolevel_model()


@pytest.fixture(scope="module")
def side():
    """(program model, reference, two batches of 2 and 1 images)."""
    s = shapes(MODEL)
    w = {part: seeded_weights(s[part], SEED, "cpu", stream)
         for part, stream in (("rough", 2), ("fine", 3))}
    model = TwoLevelFlow(TwoLevelCfg.from_ref(copy.deepcopy(MODEL)),
                         device="cpu", seed=0)
    model.load_state_dict({f"{p}.{k}": v for p in w for k, v in w[p].items()},
                          strict=True)
    ref = TwoLevel(MODEL, w["rough"], w["fine"])
    xs = [torch.as_tensor(x) for x in harness.batches(SEED, 0, 1, 2,
                                                       (30, 22, 3))]
    xs.append(torch.as_tensor(harness.batches(SEED, 2, 1, 1,
                                              (30, 22, 3))[0]))
    return model.eval(), ref, xs


def _levels(flow, x):
    """The port's (z, keep, mean, logscale) of a one-level flow."""
    with torch.no_grad():
        z, mean, logscale = flow(x)
    return [(z[0], None, mean[0], logscale[0])]


def _ties(ref_flow: Flow, x) -> int:
    """Coupling shifts of the reference within 1e-4 of a rounding tie."""
    seen = []
    real = ref_flow.dense_block

    def spy(prefix, b, h):
        out = real(prefix, b, h)
        if prefix.startswith("couples."):
            frac = (out * 256.0) - torch.floor(out * 256.0)
            seen.append(int(((frac - 0.5).abs() < 1e-4).sum()))
        return out

    ref_flow.dense_block = spy
    try:
        with torch.no_grad():
            ref_flow.forward(x)
    finally:
        del ref_flow.dense_block
    return sum(seen)


def test_split_is_exact(side):
    """The port's split (pad, pool, round, unpool, tiles) equals the
    reference's bit for bit.
    Tolerance: exact (sums of grid values over powers of two)."""
    model, ref, xs = side
    for x in xs:
        rx, px = model.split_levels(x)
        r_rx, r_px = ref.split(x)
        assert rx.shape == (x.shape[0], 4, 3, 3)
        assert px.shape == (x.shape[0] * 12, 8, 8, 3)
        assert torch.equal(rx, r_rx) and torch.equal(px, r_px)


def test_latents_and_priors_agree(side):
    """Rough and fine latents equal the reference's, but for at most one
    latent for each coupling shift within 1e-4 of a rounding tie
    (counted), and the priors agree within 1e-5 of the scale: the port's
    fused 1x1-3x3 layers sum the same float32 products in another order,
    a few ulps."""
    model, ref, xs = side
    for x in xs:
        rx, px = ref.split(x)
        for flow, ref_flow, inp in ((model.rough, ref.rough, rx),
                                    (model.fine, ref.fine, px)):
            nums = codec_numbers(ref_flow, [inp], [_levels(flow, inp)])
            ties = _ties(ref_flow, inp)
            off = round(nums["latents_off_ppm"] * inp.numel() / 1e6)
            assert off <= ties, (nums, ties)
            assert nums["prior_gap"] < 1e-5, nums


def test_codec_round_trip_and_containers(side):
    """TwoLevelCodec's default resolves to "level" on the CPU; its round
    trip is bit-exact, and the frozen reader decodes its containers, under
    the port's priors, to the port's latents.  Tolerance: exact."""
    model, _, xs = side
    codec = TwoLevelCodec(model, num_streams=32)
    assert codec.granularity == "level"
    assert codec.rough_codec.granularity == codec.fine_codec.granularity \
        == "level"
    packed = codec.compress_many(xs)
    got = codec.decompress_many(packed, fetch=True)
    assert all(np.array_equal(g, x.numpy()) for g, x in zip(got, xs))
    nr = model.cfg.rough.nsplit
    for x, (blobs, _) in zip(xs, packed):
        rx, px = model.split_levels(x)
        for flow, inp, bl in ((model.rough, rx, blobs[:nr]),
                              (model.fine, px, blobs[nr:])):
            lv = _levels(flow, inp)
            bins, ok = rans.decode_chain(
                bl, [(m.reshape(-1), ls.reshape(-1)) for _, _, m, ls in lv])
            assert ok
            assert torch.equal(bins[0], torch.round(lv[0][0] * 256.0).to(
                torch.int64).reshape(-1))


def test_spans_open_once_a_batch_with_their_counters(side):
    """`twolevel.split` opens once per compressed batch and
    `twolevel.merge` once per decompressed batch, and the codec's counters
    equal the span counts; the fine tiles are counted both ways."""
    model, _, xs = side
    codec = TwoLevelCodec(model, num_streams=32)
    timer = PhaseTimer()
    with timer.phase("round_trip"):
        codec.decompress_many(codec.compress_many(xs))
    assert timer.counts["twolevel.split"] == codec.splits == len(xs)
    assert timer.counts["twolevel.merge"] == codec.merges == len(xs)
    assert codec.tiles == 2 * 12 * sum(int(x.shape[0]) for x in xs)
