"""The PyTorch port's remaining tools held against the JAX package: the
visualizer, the classical baselines, the metrics plot, growth padding, the
single-stream oracle and the numpy CDF twins, the host C++ coder and the
registries.

Inputs come from numpy seeds and go to both packages; flax variables are
perturbed (fresh projections are zero) and loaded into the port through
`convert`.  Small size: 16x16x3 images, nflows 2, nsplit 2, growth 8,
depth 2 (the shipped vis configs narrowed to nflows 1, growth 4, depth 1).
Everything runs on the CPU (`device="cpu"`).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from finalproject_losslessimagecompression_tpu import models as JM
from finalproject_losslessimagecompression_tpu import native as jnative
from finalproject_losslessimagecompression_tpu import registry as jregistry
from finalproject_losslessimagecompression_tpu.cli import baselines as jbase
from finalproject_losslessimagecompression_tpu.cli import visualize as jvis
from finalproject_losslessimagecompression_tpu.codec import cdf as jcdf
from finalproject_losslessimagecompression_tpu.codec import oracle as jor
from finalproject_losslessimagecompression_tpu.models import config as jconfig
from finalproject_losslessimagecompression_tpu.models import layers as jlayers
from finalproject_losslessimagecompression_tpu.train import (
    checkpoint as jckpt,
)
from finalproject_losslessimagecompression_tpu.train import (
    metrics as jmetrics,
)
from finalproject_losslessimagecompression_tpu.utils import (
    plot_metrics as jplot,
)
from finalproject_losslessimagecompression_tpu.utils import (
    profiling as jprof,
)
from finalproject_losslessimagecompression_tpu_torch import convert
from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch import (
    registry as tregistry,
)
from finalproject_losslessimagecompression_tpu_torch.cli import (
    baselines as tbase,
)
from finalproject_losslessimagecompression_tpu_torch.cli import (
    visualize as tvis,
)
from finalproject_losslessimagecompression_tpu_torch.cli import yamlite
from finalproject_losslessimagecompression_tpu_torch.codec import (
    cdf as tcdf,
)
from finalproject_losslessimagecompression_tpu_torch.codec import (
    host_rans,
)
from finalproject_losslessimagecompression_tpu_torch.codec import (
    interleaved as IL,
)
from finalproject_losslessimagecompression_tpu_torch.codec import (
    oracle as tor,
)
from finalproject_losslessimagecompression_tpu_torch.data import (
    loader as tloader,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    checkpoint as tckpt,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    metrics as tmetrics,
)
from finalproject_losslessimagecompression_tpu_torch.utils import (
    plot_metrics as tplot,
)
from finalproject_losslessimagecompression_tpu_torch.utils import (
    profiling as tprof,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3):
# one call over every thread first keeps that out of the comparisons
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_pipelines import synth_loader_cfg  # noqa: E402
from test_torch_residual import _grid, _np, _perturb  # noqa: E402


def _cfgs(M, fuse=True, mult=0):
    nn = M.DenseBlockCfg(8, 2, "ReLU", fuse_1x1=fuse, growth_multiple=mult)
    return M.FlowCfg(H=16, W=16, C=3, nflows=2, nsplit=2,
                     couple=M.CouplingCfg(0.75, nn), prior_nn=nn)


@functools.lru_cache(maxsize=None)
def _pair(fuse=True):
    """(flax IDFlow, perturbed variables, port IDFlow with them), cached
    per DenseLayer layout (callers do not mutate them)."""
    jm = JM.IDFlow(_cfgs(JM, fuse))
    var = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 16, 16, 3))), 1)
    tm = TM.IDFlow(_cfgs(TM, fuse), device="cpu")
    tm.load_state_dict(convert.params_from_flax(var))
    return jm, var, tm.eval()


def _count_ties(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return int(np.count_nonzero(a != b))


# ---------------------------------------------------------------------------
# cli/visualize.py
# ---------------------------------------------------------------------------


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_visualize_matches_jax(tmp_path):
    """On the same weights, noise and corners the port's `sample` (at the
    four temperatures) and `interpolate` equal the JAX module's: sampled
    images on the grid, equal except counted rounding ties (<= 1% of
    pixels, each within 4/256); the interpolation grid PNGs of both
    modules differ in <= 1% of bytes.  Every grid file is written."""
    jm, var, tm = _pair()
    rng = np.random.default_rng(41)
    noises = [np.round(rng.logistic(0, 1, (4,) + s) * 256).astype(
        np.float32) / 256 for s in tm.latent_shapes]
    writer = tmetrics.MetricsWriter(str(tmp_path / "t"),
                                    use_tensorboard=False)
    got = tvis.sample(tm.cfg, tm, writer,
                      noises=[torch.from_numpy(n) for n in noises])
    assert sorted(got) == list(tvis.TEMPERATURES)
    gen = jax.jit(lambda p, ns: jm.apply(
        p, ns, method=JM.IDFlow.sample_from_noise))
    for t, img in got.items():
        want = np.asarray(gen(var, [jnp.asarray(n * t) for n in noises]))
        a = _np(img)
        assert np.array_equal(np.round(a * 256), a * 256)
        assert _count_ties(a, want) <= 0.01 * a.size, t
        assert np.abs(a - want).max() <= 4 / 256
        assert os.path.exists(tmp_path / "t" / "images"
                              / f"sample_t{t}_00000000.png")

    corners = _grid(42, (4, 16, 16, 3))
    imgs = tvis.interpolate(tm.cfg, tm, writer, corners, grid=4)
    assert tuple(imgs.shape) == (16, 16, 16, 3)
    jw = jmetrics.MetricsWriter(str(tmp_path / "j"), use_tensorboard=False)
    jvis.interpolate(jm.cfg, jm, var, jw, corners, grid=4)
    a = _png(tmp_path / "t" / "images" / "interpolate_00000000.png")
    b = _png(tmp_path / "j" / "images" / "interpolate_00000000.png")
    assert a.shape == b.shape == (64, 64, 3)
    assert _count_ties(a, b) <= 0.01 * a.size
    # the corners of the grid are the corner images' own latents
    np.testing.assert_allclose(_np(imgs[0]), corners[0], atol=4 / 256)


def test_visualize_main_runs_the_vis_configs(tmp_path):
    """cli.visualize.main --mode both --device cpu on both shipped vis
    configs, narrowed (nflows 1, growth 4, depth 1) and on made-up data: a
    folder of 215x178 PNGs, which vis_config1's loader pads by (1, 6) to
    its 216x184 model, and ImageNet64 npz batches.  The 216x184 model loads
    a port checkpoint, the 64x64 one a JAX msgpack checkpoint; all five
    grids are written."""
    from PIL import Image

    rng = np.random.default_rng(43)
    pngs = tmp_path / "celeba"
    pngs.mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (215, 178, 3), dtype=np.uint8)
                        ).save(pngs / f"{i}.png")
    npz = tmp_path / "imagenet64"
    npz.mkdir()
    np.savez(npz / "val_data.npz",
             data=rng.integers(0, 256, (4, 3 * 64 * 64), dtype=np.uint8))
    for name, data_key, data in (
            ("vis_config1.yaml", "path", pngs),
            ("vis_config_imagenet64.yaml", "dataset.path", npz)):
        config = yamlite.load(os.path.join(REPO, "configs", name))
        model = config["train"]["model"]
        model["nflows"] = 1
        for part in ("couple", "prior"):
            model[part]["nn"].update(growth_channel=4, depth=1)
        cfg = TM.FlowCfg.from_ref(model)
        if name == "vis_config1.yaml":
            assert (cfg.H, cfg.W) == (216, 184)
            ckpt = str(tmp_path / "vis1.ckpt")
            tm = TM.IDFlow(cfg, device="cpu", seed=3)
            tckpt.save_checkpoint(ckpt, {"params": tm.state_dict()})
        else:
            jm = JM.IDFlow(JM.FlowCfg.from_ref(model))
            var = _perturb(jax.jit(jm.init)(
                jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 44)
            ckpt = str(tmp_path / "in64.msgpack")
            jckpt.save_checkpoint(ckpt, {"params": var, "step": 0})
        model["load_path"] = ckpt
        loader = config["train"]["test_dataloader"]
        node = loader
        *parents, leaf = data_key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = str(data)
        path = tmp_path / name
        path.write_text(yaml.safe_dump(config))
        out = tmp_path / name.replace(".yaml", "")
        tvis.main(["--config", str(path), "--mode", "both", "--out",
                   str(out), "--device", "cpu"])
        files = sorted(os.listdir(out / "images"))
        assert files == sorted(
            [f"sample_t{t}_00000000.png" for t in tvis.TEMPERATURES]
            + ["interpolate_00000000.png"]), files
        assert _png(out / "images" / "interpolate_00000000.png").shape == (
            8 * cfg.H, 8 * cfg.W, 3)


def test_visualize_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """Without CUDA the visualizer's model raises unless the CPU is
    asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = yamlite.load(os.path.join(REPO, "configs",
                                      "vis_config_imagenet64.yaml"))[
        "train"]["model"]
    model = dict(model, load_path=None, nflows=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvis.load_model(model)


# ---------------------------------------------------------------------------
# cli/baselines.py and utils/plot_metrics.py
# ---------------------------------------------------------------------------


def test_baselines_match_jax():
    """`run` over the same loader config gives the same bits per codec
    (gzip, bz2, lzma, PNG, WebP, gzip of PNG) as the JAX module's `run`.
    Tolerance: exact bpd."""
    cfg = synth_loader_cfg((16, 16, 3), length=6, batch=2)
    got = tbase.run(tbase.build(tbase.DATALOADERS, cfg), max_batches=2)
    want = jbase.run(jbase.build(jbase.DATALOADERS, cfg), max_batches=2)
    assert sorted(got) == sorted(want) == sorted(
        ["gzip", "bz2", "lzma", "png", "webp", "gzip_png"])
    for codec in got:
        assert got[codec]["bpd"] == want[codec]["bpd"], codec
        assert got[codec]["bpd"] > 0


def test_baselines_main_reads_a_config(tmp_path, capsys):
    """main --config reads train.test_dataloader with the port's YAML
    reader; --synthetic runs without one."""
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({"train": {
        "test_dataloader": synth_loader_cfg((16, 16, 3), length=2)}}))
    tbase.main(["--config", str(path), "--max-batches", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == sorted(
        ["gzip", "bz2", "lzma", "png", "webp", "gzip_png"])
    tbase.main(["--synthetic", "--max-batches", "1"])
    assert len(capsys.readouterr().out.splitlines()) == 6


def test_plot_metrics_matches_jax(tmp_path):
    """load_series equals the JAX function's on a metrics.jsonl written by
    the port's MetricsWriter, and plot writes a PNG; an absent tag
    exits."""
    w = tmetrics.MetricsWriter(str(tmp_path / "log"), use_tensorboard=False)
    for step in range(1, 6):
        w.add_scalar("train bpd", 8.0 - 0.1 * step, step)
        w.add_scalar("other", step, step)
    w.close()
    log = str(tmp_path / "log")
    assert tplot.load_series(log, "train bpd") == jplot.load_series(
        log, "train bpd")
    assert tplot.load_series(log, "train bpd")[0] == [1, 2, 3, 4, 5]
    out = tmp_path / "fig" / "bpd.png"
    tplot.main([log, "--tag", "train bpd", "--out", str(out)])
    assert _png(out).ndim == 3
    with pytest.raises(SystemExit):
        tplot.plot(log, "missing", str(tmp_path / "x.png"))


# ---------------------------------------------------------------------------
# growth padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("mult", [4, 16])
def test_pad_growth_params_matches_jax(fuse, mult):
    """The port's pad of the converted weights equals
    params_from_flax(pad_growth_params(flax params)), bit for bit, in
    either flax DenseLayer layout, and loads into the
    with_growth_multiple model."""
    _, var, tm = _pair(fuse)
    got = TM.pad_growth_params(tm.state_dict(), mult)
    want = convert.params_from_flax(jlayers.pad_growth_params(var, mult))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(
            got[k], want[k]), k
    padded = TM.IDFlow(TM.with_growth_multiple(tm.cfg, mult), device="cpu")
    padded.load_state_dict(got)
    assert jconfig.with_growth_multiple(_cfgs(JM, fuse), mult) == _cfgs(
        JM, fuse, mult)
    assert TM.with_growth_multiple(tm.cfg, mult) == _cfgs(TM, fuse, mult)


@pytest.mark.parametrize("mult", [4, 16])
def test_padded_model_is_the_same_function(mult):
    """The growth-padded model's latents equal the unpadded model's except
    counted rounding ties (<= 0.1%; the wider reductions may round
    differently), means and logscales within 1e-5, and a padded FlowCodec
    round-trips a queue exactly on the CPU."""
    _, _, tm = _pair()
    padded = TM.IDFlow(TM.with_growth_multiple(tm.cfg, mult),
                       device="cpu").eval()
    padded.load_state_dict(TM.pad_growth_params(tm.state_dict(), mult))
    x = torch.from_numpy(_grid(53, (4, 16, 16, 3)))
    with torch.no_grad():
        (la, ma, sa), (lb, mb, sb) = tm(x), padded(x)
    ties = sum(_count_ties(_np(a), _np(b)) for a, b in zip(la, lb))
    assert ties <= 0.001 * sum(a.numel() for a in la), ties
    for a, b in zip(ma + sa, mb + sb):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    codec = TM.FlowCodec(padded, num_streams=64)
    xs = [x[:2], x[2:]]
    recs = codec.decompress_many(codec.compress_many(xs), fetch=True)
    assert all(np.array_equal(r, _np(b)) for r, b in zip(recs, xs))


# ---------------------------------------------------------------------------
# the oracle, the numpy CDF twins and the host coder
# ---------------------------------------------------------------------------


def _symbols(rng, n):
    """n window-clamped bins with means and scales of the prior's range."""
    means = rng.uniform(-2, 2, n).astype(np.float32)
    scales = np.exp(rng.uniform(-4, 0, n)).astype(np.float32)
    v = np.round((means + scales * rng.logistic(0, 1, n).astype(np.float32))
                 * 256).astype(np.int32)
    low = tcdf.lower_bin_np(means)
    return np.clip(v, low, low + tcdf.NBINS - 1), means, scales


def test_oracle_and_cdf_twins_match_jax():
    """The port's cdf_bits_np, symbol_freq_np and lower_bin_np equal the
    JAX package's numpy twins, and its oracle's encode (words, final state)
    and decode equal the JAX oracle's on the same inputs, bit for bit."""
    rng = np.random.default_rng(60)
    v, m, s = _symbols(rng, 3000)
    low = jcdf.lower_bin(m)
    assert np.array_equal(tcdf.lower_bin_np(m), low)
    pos = (low - 1 + rng.integers(0, tcdf.NBINS + 1, v.size)).astype(
        np.int32)
    assert np.array_equal(tcdf.cdf_bits_np(pos, m, s, low),
                          jcdf.cdf_bits_np(pos, m, s, low))
    for a, b in zip(tcdf.symbol_freq_np(v, m, s),
                    jcdf.symbol_freq_np(v, m, s)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    st, words = tor.rans_encode_np(tor.RANS_L, v, m, s)
    assert (st, words) == jor.rans_encode_np(jor.RANS_L, v, m, s)
    got = tor.rans_decode_np(st, words, v.size, m[::-1], s[::-1])
    want = jor.rans_decode_np(st, words, v.size, m[::-1], s[::-1])
    assert got[0] == want[0] == tor.RANS_L
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[1][::-1], v) and tor.roundtrip_np(v, m, s)


def _np_agreeing_symbols(rng, n):
    """n symbols whose whole-window CDF agrees bit for bit between torch's
    cdf_bits and the numpy twin (the filter of
    test_torch_coder.test_cdf_agreement_with_jnp_and_np's comparison, here
    against numpy); scales log-uniform in [1e-3, 3e-2]."""
    m = 4 * n
    means = rng.normal(0.0, 1.0, m).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(1e-3), np.log(3e-2), m)).astype(
        np.float32)
    keep = torch.exp(torch.from_numpy(np.log(scales))).numpy() == np.exp(
        np.log(scales))
    low = tcdf.lower_bin_np(means)
    pos = low[:, None] + np.arange(-1, tcdf.NBINS, dtype=np.int32)[None, :]
    mb, sb, lb = (np.broadcast_to(a[:, None], pos.shape)
                  for a in (means, scales, low))
    ct = tcdf.cdf_bits(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in (pos, mb, sb, lb))).numpy()
    keep &= np.all(ct == tcdf.cdf_bits_np(pos, mb, sb, lb), axis=1)
    idx = np.nonzero(keep)[0][:n]
    assert idx.size == n, "too few agreeing symbols drawn"
    means, scales = means[idx], scales[idx]
    v = np.round((means + scales * rng.logistic(0, 1, n).astype(np.float32))
                 * 256).astype(np.int32)
    return v, means, scales


def test_each_interleaved_stream_is_the_oracle():
    """Each stream of the port's plain interleaved coder (`encode_plain`,
    S = 16, k = 32) is the oracle's single stream on the same symbols:
    its emitted words in order and its final state, bit for bit, on
    agreement-filtered symbols (torch's CDF = the numpy twin's over the
    whole window)."""
    rng = np.random.default_rng(61)
    S, k = 16, 32
    v, m, s = _np_agreeing_symbols(rng, S * k)
    low = tcdf.lower_bin_np(m)
    v = np.clip(v, low, low + tcdf.NBINS - 1)
    t = [torch.from_numpy(a.reshape(k, S)) for a in (v, m, s, low)]
    words, flags, hi, lo = IL.encode_plain(*t)
    words, flags = words.numpy(), flags.numpy().astype(bool)
    emitted = 0
    for j in range(S):
        st, w = tor.rans_encode_np(tor.RANS_L, v.reshape(k, S)[:, j],
                                   m.reshape(k, S)[:, j],
                                   s.reshape(k, S)[:, j])
        assert st == (int(hi[j]) << 32) | int(lo[j]), j
        assert w == [int(x) for x in words[flags[:, j], j]], j
        emitted += len(w)
    assert emitted > 0  # renormalisation was exercised


def test_host_coder_matches_jax_native():
    """The port's host C++ coder equals the JAX package's native coder --
    the same C++ on the same libm -- words and states bit for bit, single
    stream and interleaved (S = 16), round-trips both ways, and chains
    states as the container does."""
    rng = np.random.default_rng(62)
    v, m, s = _symbols(rng, 16 * 128)
    st, words = host_rans.encode_single(v, m, s)
    jst, jwords = jnative.encode_single(v, m, s)
    assert st == jst and np.array_equal(words, jwords)
    st2, dec = host_rans.decode_single(st, words, v.size, m[::-1], s[::-1])
    assert st2 == tor.RANS_L and np.array_equal(dec[::-1], v)
    w, hi, lo = host_rans.encode_interleaved(v, m, s, 16)
    jw, jhi, jlo = jnative.encode_interleaved(v, m, s, 16)
    assert all(np.array_equal(a, b) for a, b in ((w, jw), (hi, jhi),
                                                 (lo, jlo)))
    out, hi2, lo2 = host_rans.decode_interleaved(w, m, s, 16, hi, lo)
    assert np.array_equal(out, v) and (hi2 == 1).all() and (lo2 == 0).all()
    states = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    buf = np.zeros(w.size + 5 * 16 + 8, np.uint32)
    buf[:w.size] = w
    jbuf = buf.copy()
    assert host_rans.chain_pack(states, buf, w.size) == jnative.chain_pack(
        states, jbuf, w.size)
    assert np.array_equal(buf, jbuf)
    with pytest.raises(ValueError):
        host_rans.encode_single(v[:5], m[:4], s[:5])


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    """Both packages declare the same registries; the name-less
    `register(obj)`, `@register`, `names()` and `in` behave as in JAX, a
    duplicate name raises KeyError, and the port registers its VQ-VAE
    modules and looks activations up in ACTIVATIONS."""
    tnames = {k for k, v in vars(tregistry).items()
              if isinstance(v, tregistry.Registry)}
    jnames = {k for k, v in vars(jregistry).items()
              if isinstance(v, jregistry.Registry)}
    assert tnames == jnames
    for mod in (tregistry, jregistry):
        reg = mod.Registry("demo")

        def swish(x):
            return x

        class Block:
            pass

        assert reg.register(swish) is swish
        assert reg.register(Block) is Block
        assert reg.register(name="alias")(swish) is swish
        assert reg.names() == ["Block", "alias", "swish"]
        assert "swish" in reg and "missing" not in reg
        with pytest.raises(KeyError):
            reg.register(name="swish")(Block)
        with pytest.raises(KeyError, match="unknown name"):
            reg.get("missing")
    assert tregistry.ENDECODERS.names() == jregistry.ENDECODERS.names() == [
        "VQDecoder", "VQEncoder", "VQVAE"]
    act = tregistry.ACTIVATIONS.register(torch.sigmoid, name="TestSigmoid")
    try:
        assert TM.activation("TestSigmoid") is act
    finally:
        del tregistry.ACTIVATIONS._record["TestSigmoid"]
    with pytest.raises(KeyError):
        TM.activation("TestSigmoid")
    assert tloader.CustomDataLoader is tregistry.DATALOADERS.get(
        "CustomDataLoader")


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------


def test_profiling_summary_and_device_trace(tmp_path):
    """PhaseTimer.summary prints what the JAX PhaseTimer prints for the
    same spans; device_trace writes a Chrome trace of the block's
    operations (host only here: no card)."""
    timers = (tprof.PhaseTimer(), jprof.PhaseTimer())
    for timer in timers:
        for name, secs in (("encode", 0.25), ("decode", 0.5),
                           ("encode", 0.125)):
            timer.totals[name] += secs
            timer.counts[name] += 1
    assert timers[0].summary() == timers[1].summary() == (
        "decode: 0.500s/1  encode: 0.375s/2")
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.name for e in prof.events())
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
