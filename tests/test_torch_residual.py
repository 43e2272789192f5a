"""The PyTorch port's VQ-VAE, conditional flow and ResidualCodec held
against the JAX package.

The same flax variables (perturbed from numpy seeds, so that projections
are not zero and BatchNorm statistics are not trivial) are loaded into the
port through `convert.params_from_flax` / `convert.vqvae_params_from_flax`,
and both packages see the same numpy inputs.  Small size: 16x16x3 images;
VQ hidden dims [8, 16], 16 codewords of 8 dims, one ResBlock; flow tiles
8x8, growth 8, depth 2, nflows 2, nsplit 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from finalproject_losslessimagecompression_tpu import models as JM
from finalproject_losslessimagecompression_tpu.models import layers as jlayers
from finalproject_losslessimagecompression_tpu.models import (
    residual_codec as jres,
)
from finalproject_losslessimagecompression_tpu.models import vqvae as jvq
from finalproject_losslessimagecompression_tpu.ops import reshape as jreshape
from finalproject_losslessimagecompression_tpu_torch import convert
from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch.models import (
    residual_codec as tres,
)
from finalproject_losslessimagecompression_tpu_torch.models import (
    vqvae as tvq,
)
from finalproject_losslessimagecompression_tpu_torch.ops import (
    patch_merge,
    patch_split,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3):
# one call over every thread first keeps that out of the comparisons
torch.exp(torch.zeros(1 << 16))

VQ_DICT = dict(
    name="VQVAE", channel=3, embed_num=16, embed_dim=8, hidden_dims=[8, 16],
    encoder=dict(name="VQEncoder", block_num=1,
                 block=dict(name="ResBlock", batch_norm=False)),
    decoder=dict(name="VQDecoder", block_num=1,
                 block=dict(name="ResBlock", batch_norm=False)),
    distribution=dict(name="BinomialDistribution"),
    vectorquantizer=dict(reinit_interval=1000, threshold=0.1),
)


def _flow_dict(conv_for_cond=True):
    nn = dict(name="DenseBlock", growth_channel=8, depth=2,
              layer=dict(name="DenseLayer", act="LeakyReLU"))
    return dict(
        name="ConditionalFlows", nflows=2, nbits=8, nsplit=2, H=8, W=8, C=3,
        couple=dict(name="AdditiveCouple", split=0.75, nn=nn,
                    round=dict(name="Round", nbits=8)),
        extenddim=dict(name="ExtendDim", scale=2),
        prior=dict(name="Prior", round=dict(name="Round", nbits=8), nn=nn),
        distribution=dict(name="DLogistic"),
        round=dict(name="Round", nbits=8),
        conv_for_cond=conv_for_cond,
    )


def _grid(seed, shape):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(0, 1, shape) * 256) / 256).astype(
        np.float32)


def _perturb(tree, seed, sd=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, sd, np.shape(a))
                   ).astype(np.float32), jax.device_get(tree))


def _np(t):
    return t.detach().cpu().numpy()


def _vq_pair(batch_norm=False, seed=0):
    """(flax VQVAE, its perturbed variables, the port's VQVAE with them)."""
    cfg = dict(VQ_DICT, batch_norm=batch_norm)
    jm = jvq.build_vqvae_from_ref(cfg)
    var = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 16, 16, 3)))
    var = _perturb(var, seed + 1)
    if batch_norm:  # running variances must stay positive
        var["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(a) + 0.5, var["batch_stats"])
    tm = tvq.build_vqvae_from_ref(cfg, device="cpu")
    tm.load_state_dict(convert.vqvae_params_from_flax(var))
    return jm, var, tm


# ---------------------------------------------------------------------------
# layout and blocks
# ---------------------------------------------------------------------------


def test_patch_split_merge_match_jax():
    """patch_split / patch_merge on torch tensors and numpy arrays equal
    the JAX package's, and merge inverts split.  Tolerance: exact."""
    x = np.random.default_rng(1).normal(size=(2, 16, 24, 3)).astype(
        np.float32)
    want = np.asarray(jreshape.patch_split(x, 8, 8))
    assert np.array_equal(_np(patch_split(torch.from_numpy(x), 8, 8)), want)
    assert np.array_equal(patch_split(x, 8, 8), want)
    assert np.array_equal(_np(patch_merge(torch.from_numpy(want), 16, 24)),
                          np.asarray(jreshape.patch_merge(want, 16, 24)))
    assert np.array_equal(patch_merge(want, 16, 24), x)
    with pytest.raises(ValueError):
        patch_split(x, 5, 8)


@pytest.mark.parametrize("batch_norm,train", [(False, False), (True, False),
                                              (True, True)],
                         ids=["plain", "bn", "bn_train"])
def test_resblock_parity(batch_norm, train):
    """ResBlock against flax's, with BatchNorm reading perturbed running
    statistics, or in train mode normalising with the batch's and updating
    them as flax does (momentum 0.99, biased variance).  Tolerance: 1e-5
    absolute."""
    jb = jlayers.ResBlock(6, batch_norm)
    x = np.random.default_rng(2).normal(size=(2, 5, 7, 6)).astype(np.float32)
    var = _perturb(jb.init(jax.random.PRNGKey(3), jnp.asarray(x)), 4, 0.1)
    if batch_norm:
        var["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(a) + 0.5, var["batch_stats"])
    if train:
        want, new = jb.apply(var, jnp.asarray(x), True,
                             mutable=["batch_stats"])
    else:
        want = jb.apply(var, jnp.asarray(x))
    want = np.asarray(want)
    out = {}
    for sub in ("conv_a", "conv_b"):
        convert._conv(var["params"][sub], f"{sub}.", out)
    for sub in ("bn_a", "bn_b") if batch_norm else ():
        convert._batch_norm(var["params"][sub], var["batch_stats"][sub],
                            f"{sub}.", out)
    tb = TM.ResBlock(6, batch_norm)
    tb.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in out.items()})
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2), train).permute(
            0, 2, 3, 1)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)
    if train:
        for sub in ("bn_a", "bn_b"):
            st = new["batch_stats"][sub]
            bn = getattr(tb, sub)
            np.testing.assert_allclose(_np(bn.running_mean), st["mean"],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(_np(bn.running_var), st["var"],
                                       rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# VQ-VAE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
def test_vqvae_parity(batch_norm):
    """Encoder, decoder (its transposed convs included), encode, decode and
    reconstruct against flax's through vqvae_params_from_flax.  Tolerance:
    floats 1e-5 absolute, indices equal."""
    jm, var, tm = _vq_pair(batch_norm)
    x = _grid(5, (2, 16, 16, 3)) * 2 - 1
    with torch.no_grad():
        tx = torch.from_numpy(x)
        h = tm.encoder(tx)
        jh = jm.apply(var, jnp.asarray(x), method=lambda m, v: m.encoder(v))
        np.testing.assert_allclose(_np(h), np.asarray(jh), rtol=0, atol=1e-5)
        z = np.random.default_rng(6).uniform(-1, 1, (2, 4, 4, 8)).astype(
            np.float32)
        np.testing.assert_allclose(
            _np(tm.decode(torch.from_numpy(z))),
            np.asarray(jm.apply(var, jnp.asarray(z), method=jvq.VQVAE.decode)),
            rtol=0, atol=1e-5)
        vq_x, loss, idx, counts, flat = tm.encode(tx)
    jvq_x, jloss, jidx, jcounts, jflat = jm.apply(
        var, jnp.asarray(x), method=jvq.VQVAE.encode)
    assert np.array_equal(_np(idx), np.asarray(jidx))
    for a, b in ((vq_x, jvq_x), (flat, jflat), (counts, jcounts)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    with torch.no_grad():
        rec = tm.reconstruct(tx)
    np.testing.assert_allclose(
        _np(rec), np.asarray(jm.apply(var, jnp.asarray(x),
                                      method=jvq.VQVAE.reconstruct)),
        rtol=0, atol=1e-5)
    # the transposed convs are not flipped by mistake: an unflipped kernel
    # gives another function
    k = var["params"]["decoder"]["ConvTranspose_0"]["kernel"]
    assert not np.allclose(k, k[::-1, ::-1])


def test_vector_quantizer_and_reinit_match_jax():
    """VectorQuantizer's output, loss, indices and counts, its gradient
    through the straight-through estimator, and vq_reinit, against the JAX
    package.  Tolerance: 1e-6 absolute (loss 1e-6 relative), indices and
    reinit decisions exact."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (40, 8)).astype(np.float32)
    jq = jvq.VectorQuantizer(16, 8)
    var = jax.device_get(jq.init(jax.random.PRNGKey(9), jnp.asarray(x)))
    tq = tvq.VectorQuantizer(16, 8)
    tq.codebook.data.copy_(torch.from_numpy(np.array(
        var["params"]["codebook"])))
    jout = jq.apply(var, jnp.asarray(x), 0.3, 0.7)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tq(tx, 0.3, 0.7)
    assert np.array_equal(_np(tout[2]), np.asarray(jout[2]))
    np.testing.assert_allclose(_np(tout[0]), np.asarray(jout[0]), atol=1e-6)
    np.testing.assert_allclose(float(tout[1].detach()), float(jout[1]),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(tout[3]), np.asarray(jout[3]), atol=1e-6)
    assert abs(float(tout[3].sum()) - 1.0) < 1e-5
    tout[0].sum().backward()  # straight through: d(vq_x)/dx = 1
    assert torch.equal(tx.grad, torch.ones_like(tx))

    cb = rng.uniform(-1, 1, (16, 8)).astype(np.float32)
    batch = rng.uniform(-1, 1, (5, 8)).astype(np.float32)
    for counts in (np.full(16, 10.0, np.float32),
                   rng.uniform(0, 150, 16).astype(np.float32),
                   np.zeros(16, np.float32)):
        want = jvq.vq_reinit(jnp.asarray(cb), jnp.asarray(counts),
                             jnp.asarray(batch), 1000.0, 0.1)
        got = tvq.vq_reinit(torch.from_numpy(cb), torch.from_numpy(counts),
                            torch.from_numpy(batch), 1000.0, 0.1)
        for a, b in zip(got, want):
            assert np.array_equal(_np(a), np.asarray(b))
    assert tvq.vqvae_reinit_params(VQ_DICT) == jvq.vqvae_reinit_params(
        VQ_DICT)


# ---------------------------------------------------------------------------
# conditional flow
# ---------------------------------------------------------------------------


def _flow_pair(conv_for_cond=True, seed=0):
    """(flax conditional IDFlow, perturbed params, port IDFlow with them)."""
    jcfg = JM.FlowCfg.from_ref(_flow_dict(conv_for_cond))
    jm = JM.IDFlow(jcfg)
    px = jnp.zeros((1, 8, 8, 3), jnp.float32)
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(seed), px, px),
                      seed + 1)
    tm = TM.IDFlow(TM.FlowCfg.from_ref(_flow_dict(conv_for_cond)),
                   device="cpu")
    tm.load_state_dict(convert.params_from_flax(params))
    return jm, params, tm


@pytest.mark.parametrize("conv_for_cond", [True, False],
                         ids=["conv", "squeeze"])
def test_conditional_idflow_parity(conv_for_cond):
    """The conditional IDFlow against flax's: cond_features within 1e-5,
    latents exact, means and logscales within 1e-5 absolute;
    forward then inverse is the identity.  Tolerance as stated."""
    jm, params, tm = _flow_pair(conv_for_cond)
    x, cond = _grid(10, (3, 8, 8, 3)), _grid(11, (3, 8, 8, 3))
    jf = jm.apply(params, jnp.asarray(cond), method=JM.IDFlow.cond_features)
    jl, jmean, jls = jm.apply(params, jnp.asarray(x), jnp.asarray(cond))
    with torch.no_grad():
        tc = torch.from_numpy(cond)
        tf = tm.cond_features(tc)
        tl, tmean, tls = tm(torch.from_numpy(x), tc)
        back = tm.inverse_from_latents(tl)
    assert [f.shape[-1] for f in tf] == [p.cond_ch for p in tm.plans]
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-5)
    for a, b in zip(tl, jl):
        assert np.array_equal(_np(a), np.asarray(b))
    for a, b in zip(tmean + tls, list(jmean) + list(jls)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-5)
    assert max(float(np.abs(np.asarray(m)).max()) for m in jmean) > 1e-2
    assert np.array_equal(_np(back), x)
    # the prior really reads the conditioning
    with torch.no_grad():
        _, other_mean, _ = tm(torch.from_numpy(x), torch.zeros_like(tc))
    assert not torch.equal(other_mean[0], tmean[0])


def test_conditional_codec_roundtrip_and_queue():
    """The conditional FlowCodec round trip is bit-exact, compress_many is
    byte-identical to per-batch compress, and a conditional flow refuses a
    queue without its conds.  Tolerance: exact."""
    _, _, tm = _flow_pair(True, seed=3)
    codec = TM.FlowCodec(tm, num_streams=32)
    xs = [_grid(20, (2, 8, 8, 3)), _grid(21, (1, 8, 8, 3))]
    conds = [_grid(22, (2, 8, 8, 3)), _grid(23, (1, 8, 8, 3))]
    packed = codec.compress_many([torch.from_numpy(x) for x in xs],
                                 [torch.from_numpy(c) for c in conds])
    for (blobs, _), x, c in zip(packed, xs, conds):
        assert blobs == codec.compress(torch.from_numpy(x),
                                       torch.from_numpy(c))[0]
    got = codec.decompress_many(packed, [torch.from_numpy(c) for c in conds],
                                fetch=True)
    assert all(np.array_equal(g, x) for g, x in zip(got, xs))
    one = codec.decompress(*packed[0], cond=torch.from_numpy(conds[0]))
    assert np.array_equal(_np(one), xs[0])
    with pytest.raises(ValueError, match="cond"):
        codec.compress_many([torch.from_numpy(xs[0])])


# ---------------------------------------------------------------------------
# index stream and ResidualCodec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [2, 16, 1000, 8192])
def test_pack_indices_byte_identical_to_jax(K):
    """The VQIX stream equals the JAX package's byte for byte, unpacks in
    both packages, and malformed streams raise ValueError.  Tolerance:
    exact."""
    idx = np.random.default_rng(K).integers(0, K, (3, 4, 5)).astype(np.int32)
    blob = tres._pack_indices(idx, K)
    assert blob == jres._pack_indices(idx, K)
    for unpack in (tres._unpack_indices, jres._unpack_indices):
        got, k = unpack(blob)
        assert k == K and np.array_equal(got, idx)
    with pytest.raises(ValueError):
        tres._unpack_indices(b"VQIY" + blob[4:])
    with pytest.raises(ValueError):
        tres._unpack_indices(blob[:-1])
    with pytest.raises(ValueError):
        tres._pack_indices(idx + K, K)
    if K & (K - 1):  # a bit pattern >= K fits in ceil(log2 K) bits
        bad = bytearray(blob)
        bad[20:] = b"\xff" * (len(bad) - 20)
        with pytest.raises(ValueError, match="range"):
            tres._unpack_indices(bytes(bad))


@pytest.fixture(scope="module")
def residual_pair():
    """(JAX ResidualCodec, its flow params, port ResidualCodec), the same
    perturbed weights on both sides."""
    jvqm, vq_var, tvqm = _vq_pair(seed=30)
    jflow, params, tflow = _flow_pair(True, seed=31)
    jcodec = jres.ResidualCodec(jvqm, vq_var,
                                JM.FlowCodec(jflow, num_streams=32),
                                (16, 16))
    tcodec = TM.ResidualCodec(tvqm, TM.FlowCodec(tflow, num_streams=32),
                              (16, 16))
    return jcodec, params, tcodec


def test_residual_codec_roundtrip(residual_pair):
    """ResidualCodec decodes with no side information, bit-exact;
    coded_bits counts the index stream; compress_many (index streams and
    containers) is byte-identical to per-batch compress;
    decompress_many(fetch=True) returns numpy.  Tolerance: exact."""
    _, _, codec = residual_pair
    x, x2 = _grid(40, (2, 16, 16, 3)), _grid(41, (1, 16, 16, 3))
    idx_blob, blobs, info = codec.compress(torch.from_numpy(x))
    assert info == {"batch": 8, "images": 2}
    assert np.array_equal(_np(codec.decompress(idx_blob, blobs, info)), x)
    assert codec.coded_bits(idx_blob, blobs) == 8 * len(idx_blob) + sum(
        8 * len(b) for b in blobs)
    assert 0 < codec.real_bpd(idx_blob, blobs, info) < 64
    packed = codec.compress_many([torch.from_numpy(x), x2])
    assert packed[0] == (idx_blob, blobs, info)
    assert packed[1] == codec.compress(x2)
    recs = codec.decompress_many(packed, fetch=True)
    assert all(isinstance(r, np.ndarray) for r in recs)
    assert np.array_equal(recs[0], x) and np.array_equal(recs[1], x2)


def test_residual_codec_corrupt_index_stream(residual_pair):
    """A corrupt index stream raises ValueError or decodes to something
    detectably different (the conditioning changed).  Tolerance: exact."""
    _, _, codec = residual_pair
    x = _grid(42, (1, 16, 16, 3))
    idx_blob, blobs, info = codec.compress(x)
    bad = bytearray(idx_blob)
    bad[0] ^= 0xFF
    with pytest.raises(ValueError):
        codec.decompress(bytes(bad), blobs, info)
    bad = bytearray(idx_blob)
    bad[-1] ^= 0x55
    try:
        out = codec.decompress(bytes(bad), blobs, info, fetch=True)
        assert not np.array_equal(out, x)
    except ValueError:
        pass


def test_residual_index_stream_matches_jax(residual_pair):
    """On the same converted weights and input, the port's index stream
    equals the JAX ResidualCodec's (the agreement rate is in the message
    should a near tie ever split them), and both code the residual at a
    rate within 1%.  Tolerance: exact stream, 1% rate."""
    jcodec, params, codec = residual_pair
    x = _grid(43, (4, 16, 16, 3))
    jidx, jblobs, jinfo = jcodec.compress(params, jnp.asarray(x))
    idx, blobs, info = codec.compress(x)
    a, b = jres._unpack_indices(jidx)[0], tres._unpack_indices(idx)[0]
    rate = float(np.mean(a == b))
    assert idx == jidx, f"index agreement {rate:.4f}"
    bpd, jbpd = codec.real_bpd(idx, blobs, info), jcodec.real_bpd(
        jidx, jblobs, jinfo)
    assert abs(bpd - jbpd) <= 0.01 * jbpd, (bpd, jbpd)
