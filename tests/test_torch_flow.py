"""The PyTorch port's flow model and codec held against the JAX package.

The same flax parameters (perturbed from numpy seeds, so that projections
are not zero) are loaded into the port through `convert.params_from_flax`,
in both DenseLayer layouts, and both packages see the same numpy inputs.
Small size: 16x16x3 images, nflows 2, nsplit 2, growth 8, depth 2, batch 2.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from finalproject_losslessimagecompression_tpu import models as JM
from finalproject_losslessimagecompression_tpu.models import idflow as jidflow
from finalproject_losslessimagecompression_tpu.ops import dlogistic as jdl
from finalproject_losslessimagecompression_tpu.ops import reshape as jreshape
from finalproject_losslessimagecompression_tpu.ops import rounding as jround
from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch.convert import (
    params_from_flax,
)
from finalproject_losslessimagecompression_tpu_torch.models import (
    idflow as tidflow,
)
from finalproject_losslessimagecompression_tpu_torch.ops import (
    dlogistic_log_prob,
    depth_to_space,
    round_ste,
    round_to_grid,
    space_to_depth,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# In about 1% of fresh processes, the first parallel call of torch's CPU
# exp (MKL VML, chunks of 2048) computes the worker thread's chunk with
# ~1.5e-4 relative error; later calls are exact to an ulp.  One call over
# every thread first keeps that out of the comparisons below.
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BATCH = 2


def _cfgs(M, fuse):
    nn = M.DenseBlockCfg(8, 2, "ReLU", fuse_1x1=fuse)
    return M.FlowCfg(H=16, W=16, C=3, nflows=2, nsplit=2,
                     couple=M.CouplingCfg(0.75, nn), prior_nn=nn)


def _images(seed, batch=BATCH):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(0, 1, (batch, 16, 16, 3)) * 256)
            / 256).astype(np.float32)


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "unfused"])
def pair(request):
    """(JAX model, flax params, port model) with the same perturbed
    weights."""
    fuse = request.param
    jm = JM.IDFlow(_cfgs(JM, fuse))
    params = jax.device_get(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(_images(0))))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, np.shape(a))
                   ).astype(np.float32), params)
    tm = TM.IDFlow(_cfgs(TM, fuse), device="cpu", seed=0)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_space_to_depth_matches_jax_order():
    """space_to_depth / depth_to_space use the JAX package's sub-pixel-major
    channel order (not pixel_unshuffle's).  Tolerance: exact."""
    x = np.random.default_rng(1).normal(size=(2, 8, 6, 5)).astype(np.float32)
    y = space_to_depth(torch.from_numpy(x), 2)
    assert np.array_equal(_np(y), np.asarray(jreshape.space_to_depth(x, 2)))
    assert np.array_equal(_np(depth_to_space(y, 2)), x)
    assert not np.array_equal(
        _np(y), _np(torch.nn.functional.pixel_unshuffle(
            torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)))


def test_rounding_half_to_even_and_straight_through():
    """round_to_grid and round_ste equal the JAX versions, ties to even, and
    round_ste's gradient is the identity.  Tolerance: exact."""
    x = (np.arange(-40, 40, dtype=np.float32) + 0.5) / 256
    x = np.concatenate([x, np.random.default_rng(2).normal(size=100)
                        .astype(np.float32)])
    want = np.asarray(jround.round_to_grid(jnp.asarray(x)))
    assert np.array_equal(_np(round_to_grid(torch.from_numpy(x))), want)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = round_ste(xt)
    assert np.array_equal(_np(y), np.asarray(jround.round_ste(jnp.asarray(x))))
    y.sum().backward()
    assert torch.equal(xt.grad, torch.ones_like(xt))


def _dlogistic_inputs():
    rng = np.random.default_rng(3)
    x = np.round(rng.normal(0, 2, 4000) * 256).astype(np.float32) / 256
    mean = rng.normal(0, 1, 4000).astype(np.float32)
    ls = rng.uniform(-6.24, 1.0, 4000).astype(np.float32)
    return x, mean, ls


def _dlogistic_reference(x, mean, ls, nbits=8, eps=1e-8):
    """(ref, bound): the log-prob of the float32 inputs evaluated in
    float64, and a first-order bound on the error of a float32 evaluation
    of the same formula -- one rounding per arithmetic operation, two per
    exp, log and log-sigmoid, propagated through each derivative.  The
    bound is large where d = logsigmoid(x_neg) - logsigmoid(x_pos) cancels
    (scales above 1, |x - mean| of a few scales), since log(-expm1(d))
    amplifies d's error by 1/|d|."""
    u = 2.0 ** -24
    x, mean, ls = (np.asarray(a, np.float64) for a in (x, mean, ls))
    s, h = np.exp(ls), 0.5 / 2 ** nbits

    def lsig(v):
        return np.minimum(v, 0) - np.log1p(np.exp(-np.abs(v)))

    def sig(v):
        return 0.5 * (1.0 + np.tanh(v / 2))

    xp, xn = (x + h - mean) / s, (x - h - mean) / s
    lfp, lfn = lsig(xp), lsig(xn)
    d = np.minimum(lfn - lfp, 0.0)
    log_term = np.log(-np.expm1(d) + eps)
    ref = lfp + log_term
    err_xp = u * ((np.abs(x) + h + np.abs(x + h - mean)) / s + 2 * np.abs(xp))
    err_xn = u * ((np.abs(x) + h + np.abs(x - h - mean)) / s + 2 * np.abs(xn))
    err_lfp = sig(-xp) * err_xp + 2 * u * np.abs(lfp)
    err_lfn = sig(-xn) * err_xn + 2 * u * np.abs(lfn)
    err_d = err_lfp + err_lfn + u * np.abs(d)
    err_log = (np.exp(d) / (-np.expm1(d) + eps) * err_d
               + 2 * u * np.abs(log_term))
    return ref, err_lfp + err_log + u * np.abs(ref)


def _check_dlogistic(got, ref, bound):
    assert np.all(np.isfinite(got))
    ratio = np.abs(got.astype(np.float64) - ref) / bound
    assert ratio.max() <= 2.0, (float(ratio.max()), int(ratio.argmax()))


def test_dlogistic_log_prob_matches_jax():
    """The -expm1 form with the diff <= 0 clamp, against the JAX version,
    including far tails (log-probs to -4000).  Tolerance: 1e-4 relative
    (float32 log/exp differ by an ulp between backends).  Each package is
    also held to a float64 evaluation of the same formula on the same
    float32 inputs, within twice the first-order float32 error bound of
    `_dlogistic_reference` (both measured within 0.57 of it), which finds
    a faulty exp in either package at its first wrong element."""
    x, mean, ls = _dlogistic_inputs()
    got = _np(dlogistic_log_prob(torch.from_numpy(x), torch.from_numpy(mean),
                                 torch.from_numpy(ls)))
    want = np.asarray(jdl.dlogistic_log_prob(x, mean, ls))
    ref, bound = _dlogistic_reference(x, mean, ls)
    _check_dlogistic(got, ref, bound)
    _check_dlogistic(want, ref, bound)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


@pytest.mark.parametrize("capability", ["default", "avx2", "avx512"])
def test_dlogistic_log_prob_bound_per_cpu_capability(capability, tmp_path):
    """torch's CPU kernels dispatch on the CPU's vector capability, and the
    dispatch paths round differently (up to 1.5e-5 relative between
    `default` and AVX-512 on these inputs).  Each path, forced with
    ATEN_CPU_CAPABILITY in a fresh interpreter, stays within the bound of
    test_dlogistic_log_prob_matches_jax.  Tolerance: 2x the bound."""
    out = tmp_path / "logp.npy"
    code = (
        "import numpy as np, torch, sys\n"
        "from finalproject_losslessimagecompression_tpu_torch.ops import "
        "dlogistic_log_prob\n"
        "x, m, ls = (torch.from_numpy(a) for a in np.load(sys.argv[1]))\n"
        "np.save(sys.argv[2], dlogistic_log_prob(x, m, ls).numpy())\n"
        "print(torch.backends.cpu.get_cpu_capability())\n"
    )
    inputs = tmp_path / "inputs.npy"
    np.save(inputs, np.stack(_dlogistic_inputs()))
    env = dict(os.environ, PYTHONPATH=REPO, ATEN_CPU_CAPABILITY=capability,
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(inputs), str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    _check_dlogistic(np.load(out), *_dlogistic_reference(
        *_dlogistic_inputs()))


def test_fold_batch_matches_jax():
    """fold_batch / unfold_batch against the JAX package.  Tolerance:
    exact."""
    x = _images(4, batch=3)
    got = tidflow.fold_batch(torch.from_numpy(x), 4)
    assert np.array_equal(_np(got), np.asarray(jidflow.fold_batch(x, 4)))
    back = tidflow.unfold_batch(got, 3)
    assert np.array_equal(_np(back)[:3], x)


# ---------------------------------------------------------------------------
# model parity
# ---------------------------------------------------------------------------


def test_dense_block_parity(pair):
    """A coupling DenseBlock (its raw output, before rounding) against the
    flax block with the same weights.  Tolerance: 1e-4 absolute (conv
    summation order differs between XLA and torch)."""
    jm, params, tm = pair
    cfg = jm.cfg
    xa = np.random.default_rng(5).normal(size=(BATCH, 8, 8, 9)).astype(
        np.float32)
    block = JM.DenseBlock(3, cfg.couple.nn)
    want = np.asarray(block.apply(
        {"params": params["params"]["couples_0_1"]["dense"]}, xa))
    got = tm.couples[0][1].dense(torch.from_numpy(xa).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), want, rtol=0,
                               atol=1e-4)
    assert np.abs(want).max() > 1e-2  # the projection is not trivial


@pytest.mark.parametrize("level", [0, 1])
def test_prior_parity(pair, level):
    """prior_params (mean, logscale) against the JAX model's.  Tolerance:
    1e-4 absolute (conv summation order)."""
    jm, params, tm = pair
    p = tm.plans[level]
    ch = p.z_ch if level == tm.cfg.nsplit - 1 else p.keep_ch
    ref = np.round(np.random.default_rng(level).normal(
        size=(BATCH, p.h, p.w, ch)) * 256).astype(np.float32) / 256
    jmean, jls = jm.apply(params, jnp.asarray(ref), level,
                          method=JM.IDFlow.prior_params)
    with torch.no_grad():
        tmean, tls = tm.prior_params(torch.from_numpy(ref), level)
    np.testing.assert_allclose(_np(tmean), np.asarray(jmean), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(_np(tls), np.asarray(jls), rtol=0, atol=1e-4)


def test_latents_and_log_likelihood_parity(pair):
    """Forward latents equal the JAX model's on the 1/256 grid, except
    counted rounding ties (<= 0.1% of elements, each one 1/256 step off);
    log_likelihood agrees within 1e-4 relative (conv summation order)."""
    jm, params, tm = pair
    x = _images(8)
    jl, jmean, jls = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        tl, tmean, tls = tm(torch.from_numpy(x))
    off = total = 0
    for a, b in zip(jl, tl):
        d = np.abs(np.asarray(a) - _np(b))
        assert np.all((d == 0) | (d == np.float32(1 / 256)))
        off += int(np.count_nonzero(d))
        total += d.size
    assert off <= 0.001 * total
    jlp, _ = jidflow.log_likelihood(jm.cfg, jl, jmean, jls)
    with torch.no_grad():
        tlp, _ = tidflow.log_likelihood(tm.cfg, tl, tmean, tls)
    np.testing.assert_allclose(_np(tlp), np.asarray(jlp), rtol=1e-4)


def test_forward_inverse_is_identity(pair):
    """inverse_from_latents(forward(x)) == x.  Tolerance: exact."""
    _, _, tm = pair
    x = _images(9)
    with torch.no_grad():
        lat, _, _ = tm(torch.from_numpy(x))
        back = tm.inverse_from_latents(lat)
    assert np.array_equal(_np(back), x)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def test_codec_roundtrip_and_real_bpd(pair):
    """Port FlowCodec compress -> decompress is bit-exact on the CPU, and
    its real_bpd is within 1% of the JAX FlowCodec's on the same batch and
    weights (the containers differ where exp differs between backends)."""
    jm, params, tm = pair
    x = _images(10)
    codec = TM.FlowCodec(tm)
    blobs, info = codec.compress(torch.from_numpy(x))
    assert np.array_equal(codec.decompress(blobs, info, fetch=True), x)
    jcodec = JM.FlowCodec(jm)
    jblobs, jinfo = jcodec.compress(params, jnp.asarray(x))
    bpd, jbpd = codec.real_bpd(blobs, info), jcodec.real_bpd(jblobs, jinfo)
    assert abs(bpd - jbpd) <= 0.01 * jbpd, (bpd, jbpd)


def test_codec_queue_one_sync_paths(pair):
    """compress_many / decompress_many over a queue, fetched as numpy and
    kept as tensors, agree with per-batch compress.  Tolerance: exact."""
    _, _, tm = pair
    xs = [_images(11), _images(12, batch=1)]
    codec = TM.FlowCodec(tm)
    packed = codec.compress_many([torch.from_numpy(x) for x in xs])
    for (blobs, info), x in zip(packed, xs):
        assert blobs == codec.compress(torch.from_numpy(x))[0]
    got = codec.decompress_many(packed, fetch=True)
    assert all(np.array_equal(g, x) for g, x in zip(got, xs))
    got = codec.decompress_many(packed)
    assert all(np.array_equal(_np(g), x) for g, x in zip(got, xs))


def test_codec_queue_level_major_byte_identical(pair):
    """A queue of three batches, the last one shorter: compress_many codes
    each level of all batches in one launch per stream layout, and its
    containers equal per-batch compress byte for byte; decompress_many
    walks the levels the same way and returns every batch exactly.
    Tolerance: exact."""
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        cuda_rans,
    )

    _, _, tm = pair
    xs = [_images(20), _images(21), _images(22, batch=1)]
    codec = TM.FlowCodec(tm)
    packed = codec.compress_many([torch.from_numpy(x) for x in xs])
    assert [blobs for blobs, _ in packed] == [
        codec.compress(torch.from_numpy(x))[0] for x in xs]
    assert [info["batch"] for _, info in packed] == [BATCH, BATCH, 1]
    got = codec.decompress_many(packed, fetch=True)
    assert all(np.array_equal(g, x) for g, x in zip(got, xs))
    # CPU tensors take the plain path: no kernel was launched
    assert cuda_rans.rans_encode.launches == 0
    assert cuda_rans.rans_decode.launches == 0


def test_codec_rejects_bad_containers(pair):
    """Containers that do not match the level plans, or a corrupted one,
    raise ValueError.  Tolerance: exact."""
    _, _, tm = pair
    codec = TM.FlowCodec(tm)
    blobs, info = codec.compress(torch.from_numpy(_images(13)))
    with pytest.raises(ValueError):
        codec.decompress(blobs[:1], info)
    with pytest.raises(ValueError):
        codec.decompress(blobs[::-1], info)
    with pytest.raises(ValueError):
        codec.decompress(blobs, {"batch": 1})
    bad = bytearray(blobs[1])
    bad[40] ^= 0x5A
    with pytest.raises(ValueError):
        codec.decompress([blobs[0], bytes(bad)], info)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """With no CUDA device, a model built without an explicit device
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.IDFlow(_cfgs(TM, True))
    assert TM.IDFlow(_cfgs(TM, True), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("variant", ["batch_squeeze", "bfloat16"])
def test_codec_roundtrip_config_variants(variant):
    """The port's FlowCodec round trip under the batch-squeeze fold (a
    batch smaller than the fold is padded) and with bfloat16 DenseBlocks.
    Tolerance: exact."""
    from dataclasses import replace

    cfg = _cfgs(TM, True)
    if variant == "batch_squeeze":
        cfg = replace(cfg, batch_squeeze=2)
    else:
        nn = replace(cfg.prior_nn, dtype="bfloat16")
        cfg = replace(cfg, prior_nn=nn, couple=replace(cfg.couple, nn=nn))
    tm = TM.IDFlow(cfg, device="cpu", seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if ".proj." in name:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    codec = TM.FlowCodec(tm)
    for batch in (1, 2):
        x = _images(14 + batch, batch=batch)
        blobs, info = codec.compress(torch.from_numpy(x))
        assert np.array_equal(codec.decompress(blobs, info, fetch=True), x)
