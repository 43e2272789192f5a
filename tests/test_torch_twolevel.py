"""The PyTorch port's two-level pyramid held against the JAX package: the
model (pool matrices, level split, forward, bpd, sampling), the codec
(bit-exact round trips, the lcm padding, queue and blob order), the trainer
and the file CLI's two-level pipeline.

The same flax variables (perturbed from numpy seeds, so that projections
are not zero) go into the port through `convert.twolevel_params_from_flax`
and both packages see the same numpy inputs.  Small size: 15x15 or 16x16
images; rough flows 4x4 or 6x6, fine tiles 8x8; nflows 2, growth 8, depth
2.  Everything runs on the CPU (`device="cpu"`).
"""

import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from finalproject_losslessimagecompression_tpu.models import (
    twolevel as jtl,
)
from finalproject_losslessimagecompression_tpu.models import (
    twolevel_codec as jtlc,
)
from finalproject_losslessimagecompression_tpu.train import optim as joptim
from finalproject_losslessimagecompression_tpu.train import (
    twolevel_trainer as jtlt,
)
from finalproject_losslessimagecompression_tpu_torch import convert
from finalproject_losslessimagecompression_tpu_torch.cli import codec as C
from finalproject_losslessimagecompression_tpu_torch.codec import cuda_rans
from finalproject_losslessimagecompression_tpu_torch.models import (
    twolevel as ttl,
)
from finalproject_losslessimagecompression_tpu_torch.models.twolevel_codec import (  # noqa: E501
    TwoLevelCodec,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    checkpoint as tckpt,
)
from finalproject_losslessimagecompression_tpu_torch.train.twolevel_trainer import (  # noqa: E501
    TwoLevelTrainer,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3):
# one call over every thread first keeps that out of the comparisons
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_pipelines import small_flow_dict  # noqa: E402
from test_torch_residual import _grid, _np, _perturb  # noqa: E402

# (H, W, pad, rough (H, W, scale)): the divisible 15x15 case, and a
# non-divisible one the codec pads to (24, 24)
PADDED = (15, 15, (1, 1), (4, 4, 2))
NONDIV = (16, 16, (0, 0), (6, 6, 1))


def _tl_dict(geom=PADDED):
    H, W, pad, (rh, rw, scale) = geom
    return dict(name="TwoLevelFlows", H=H, W=W, C=3, pad=list(pad),
                rough_flows=small_flow_dict(rh, rw, scale=scale),
                fine_flows=small_flow_dict(8, 8, scale=2), batchsize=256)


def _pair(geom=PADDED, seed=0):
    """(flax TwoLevelFlow, perturbed variables, port TwoLevelFlow with
    them)."""
    d = _tl_dict(geom)
    jm = jtl.TwoLevelFlow(jtl.TwoLevelCfg.from_ref(d))
    var = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                           jnp.zeros((1, d["H"], d["W"], 3), jnp.float32))
    var = _perturb(var, seed + 1)
    tm = ttl.TwoLevelFlow(ttl.TwoLevelCfg.from_ref(d), device="cpu")
    tm.load_state_dict(convert.twolevel_params_from_flax(var))
    return jm, var, tm


def _ties(a, b):
    """Elements that differ (rounding ties of two float evaluations)."""
    a, b = _np(a) if isinstance(a, torch.Tensor) else a, np.asarray(b)
    assert a.shape == b.shape
    return int(np.count_nonzero(a != b))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_adaptive_pool_matrix_bit_equal():
    """adaptive_pool_matrix equals the numpy original for pooling and
    upsampling ratios, divisible or not; a divisible upsampling is one-hot
    (a replication).  Tolerance: exact."""
    for n_in in range(1, 30):
        for n_out in (1, 3, 4, 6, 8, 16, 23, 27):
            got = ttl.adaptive_pool_matrix(n_in, n_out)
            want = jtl.adaptive_pool_matrix(n_in, n_out)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    up = ttl.adaptive_pool_matrix(23, 184)
    assert np.array_equal(up, (up > 0).astype(np.float32))
    assert np.array_equal(up.sum(1), np.ones(184, np.float32))


@pytest.mark.parametrize("geom", [PADDED, NONDIV], ids=["padded", "nondiv"])
def test_model_matches_jax(geom):
    """The converted TwoLevelFlow against flax's: the flax sub-trees are
    named `rough` and `fine` (nn.remat keeps the name); split_levels' rx
    equal except counted rounding ties (none where the pooling windows
    are powers of two, at most 1% of rough pixels, one grid step each,
    where they are not) and px within one grid step; on the same level
    inputs both sub-flows' latents exact and means and logscales within
    1e-5; in the exact geometry the whole forward the same; twolevel_bpd
    within 1e-5 relative."""
    jm, var, tm = _pair(geom)
    assert set(var["params"]) == {"rough", "fine"}
    x = _grid(3, (2, geom[0], geom[1], 3))
    jrx, jpx = jm.apply(var, jnp.asarray(x),
                        method=jtl.TwoLevelFlow.split_levels)
    with torch.no_grad():
        rx, px = tm.split_levels(torch.from_numpy(x))
    ties = _ties(rx, jrx)
    assert ties == 0 if geom is PADDED else ties <= 0.01 * rx.numel()
    assert np.abs(_np(rx) - np.asarray(jrx)).max() <= 1 / 256
    assert np.abs(_np(px) - np.asarray(jpx)).max() <= 1 / 256 + 1e-6
    with torch.no_grad():
        outs = [tm.rough(torch.from_numpy(np.array(jrx))),
                tm.fine(torch.from_numpy(np.array(jpx)))]
    jouts = [jm.apply(var, jrx, method=lambda m, v: m.rough(v)),
             jm.apply(var, jpx, method=lambda m, v: m.fine(v))]
    if geom is PADDED:
        with torch.no_grad():
            outs += list(tm(torch.from_numpy(x)))
        jouts += list(jm.apply(var, jnp.asarray(x)))
    for (tl, tmean, tls), (jl, jmean, jls) in zip(outs, jouts):
        for a, b in zip(tl, jl):
            assert np.array_equal(_np(a), np.asarray(b))
        for a, b in zip(list(tmean) + list(tls), list(jmean) + list(jls)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=1e-5)
    assert max(float(np.abs(np.asarray(m)).max()) for m in jouts[1][1]) > 1e-2
    cfg = tm.cfg
    for b1, b2 in ((3.1, 4.7), (0.5, 9.25)):
        np.testing.assert_allclose(
            ttl.twolevel_bpd(cfg, b1, b2),
            jtl.twolevel_bpd(jtl.TwoLevelCfg.from_ref(_tl_dict(geom)), b1,
                             b2), rtol=1e-5)
    assert [tuple(s) for s in tm.latent_shapes] == [
        tuple(s) for s in jm.latent_shapes]


def test_sample_from_noise_matches_jax():
    """sample_from_noise from the same logistic noise: on the 1/256 grid,
    and equal to the JAX model's except counted rounding ties (<= 0.1% of
    elements)."""
    jm, var, tm = _pair(PADDED, seed=4)
    rng = np.random.default_rng(5)
    noises = [(0.5 * rng.logistic(0, 1, (2,) + tuple(s))).astype(np.float32)
              for s in jm.latent_shapes]
    want = np.asarray(jm.apply(var, [jnp.asarray(n) for n in noises],
                               method=jtl.TwoLevelFlow.sample_from_noise))
    with torch.no_grad():
        got = _np(tm.sample_from_noise([torch.from_numpy(n)
                                        for n in noises]))
    assert got.shape == want.shape == (2, 15, 15, 3)
    assert np.all(np.round(got * 256) == got * 256)
    assert _ties(got, want) <= 0.001 * got.size


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geom,coded", [(PADDED, (16, 16)),
                                        (NONDIV, (24, 24))],
                         ids=["padded", "nondiv"])
def test_codec_roundtrip_queue_and_blob_order(geom, coded):
    """TwoLevelCodec round trips bit-exactly over its coded dims (the
    JAX codec's (Hc, Wc)); compress_many is byte-identical to per-batch
    compress; each batch's blobs are the rough containers, then the fine
    ones, equal to each sub-flow's FlowCodec on the split levels;
    decompress_many(fetch=True) returns numpy; no kernel launches on the
    CPU.  Tolerance: exact."""
    jm, _, tm = _pair(geom, seed=6)
    codec = TwoLevelCodec(tm, num_streams=32)
    assert (codec.Hc, codec.Wc) == coded == (
        jtlc.TwoLevelCodec(jm, 32).Hc, jtlc.TwoLevelCodec(jm, 32).Wc)
    launches = cuda_rans.rans_decode.launches
    x, x2 = _grid(7, (2, geom[0], geom[1], 3)), _grid(8, (1, geom[0],
                                                          geom[1], 3))
    blobs, info = codec.compress(torch.from_numpy(x))
    assert info["batch"] == 2 and info["fine"]["batch"] == 2 * (
        coded[0] // 8) * (coded[1] // 8)
    assert np.array_equal(_np(codec.decompress(blobs, info)), x)
    assert 0 < codec.real_bpd(blobs, info) < 48
    packed = codec.compress_many([x, x2])
    assert packed[0] == (blobs, info)
    assert packed[1] == codec.compress(x2)
    with torch.no_grad():
        rx, px = codec._split(torch.from_numpy(x))
    nr = tm.cfg.rough.nsplit
    assert blobs[:nr] == codec.rough_codec.compress(rx)[0]
    assert blobs[nr:] == codec.fine_codec.compress(px)[0]
    recs = codec.decompress_many(packed, fetch=True)
    assert all(isinstance(r, np.ndarray) for r in recs)
    assert np.array_equal(recs[0], x) and np.array_equal(recs[1], x2)
    assert cuda_rans.rans_decode.launches == launches
    bad = list(blobs)
    bad[nr], bad[0] = bad[0], bad[nr]  # the levels' order matters
    with pytest.raises(ValueError):
        codec.decompress(bad, info)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _train_cfg(tmp_path, **over):
    data = dict(name="CustomDataLoader",
                dataset=dict(name="SyntheticImages", size=[15, 15, 3],
                             length=4, seed=1),
                batch_size=2, nbits=8)
    cfg = dict(model=_tl_dict(), train_dataloader={**data, "train": True},
               test_dataloader={**data, "train": False, "shuffle": False},
               optimizer=dict(name="Adamax", lr=1e-3),
               scheduler=dict(name="Constant"), max_step=2,
               step_per_epoch=1000, evaluate_interval=1000,
               save_interval=1000, save_path=str(tmp_path / "tl.ckpt"),
               writer_path=str(tmp_path / "logs"), num_streams=32)
    cfg.update(over)
    return cfg


def _logged(path, tag):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in recs if r["tag"] == tag]


def test_trainer_step_matches_jax(tmp_path):
    """One step of the port's TwoLevelTrainer (fine flow under
    torch.utils.checkpoint) against make_twolevel_step on the same
    variables and batch: the loss and its rough and fine parts within 1e-5
    relative, and the step moved exactly the tensors JAX's moved (the last
    level's prior sees zeros, so some get no gradient)."""
    jm, var, _ = _pair(PADDED, seed=9)
    jopt = joptim.build_optimizer(dict(name="Adamax", lr=1e-3),
                                  dict(name="Constant"), 1000)
    step, _ = jtlt.make_twolevel_step(jm, jopt)
    x = _grid(10, (2, 15, 15, 3))
    jvar = jax.tree_util.tree_map(jnp.asarray, var)
    jp, _, jloss, jaux = step(jvar, jopt.init(jvar), jnp.asarray(x))
    jmoved = {k: not np.array_equal(v.numpy(), w.numpy()) for (k, v), w in zip(
        convert.twolevel_params_from_flax(var).items(),
        convert.twolevel_params_from_flax(jax.device_get(jp)).values())}
    tt = TwoLevelTrainer(**_train_cfg(tmp_path), device="cpu")
    tt.model.load_state_dict(convert.twolevel_params_from_flax(var))
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    loss, aux = tt.train_step(torch.from_numpy(x))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(_np(aux), [float(a) for a in jaux],
                               rtol=1e-5)
    moved = {k: not torch.equal(before[k], v)
             for k, v in tt.model.state_dict().items()}
    assert moved == jmoved and sum(moved.values()) > len(moved) // 2


def test_trainer_cadence_eval_samples_resume(tmp_path):
    """log_every 2 over 4 steps: train bpd, bpd 1 and bpd 2 at steps 2 and
    4 only; eval at step 4 with test_coding codes the test batches through
    TwoLevelCodec with 0 errors and logs the real bpd; sample_images gives
    four temperatures of [4, 15, 15, 3] on the grid; a resumed trainer
    holds the saved params, optimizer state and step.  Tolerance: exact."""
    tt = TwoLevelTrainer(**_train_cfg(tmp_path, max_step=4, log_every=2,
                                      evaluate_interval=4, save_interval=4,
                                      test_coding=True), device="cpu")
    tt.train()
    logs = tmp_path / "logs"
    for tag in ("train bpd", "train bpd 1", "train bpd 2"):
        assert [s for s, _ in _logged(logs, tag)] == [2, 4], tag
    assert _logged(logs, "coding errors") == [(4, 0.0)]
    assert [s for s, _ in _logged(logs, "real bpd")] == [4]
    assert np.isfinite(_logged(logs, "test bpd 2")[0][1])
    imgs = tt.sample_images()
    assert sorted(imgs) == [0.25, 0.5, 0.75, 1.0]
    for img in imgs.values():
        assert img.shape == (4, 15, 15, 3)
        assert np.all(np.round(img * 256) == img * 256)
    cfg = _train_cfg(tmp_path / "b")
    cfg["model"] = dict(cfg["model"], load_path=tt.save_path)
    t2 = TwoLevelTrainer(**cfg, device="cpu")
    assert t2.step == 4 and t2.optimizer.count == 4
    for (n, a), b in zip(tt.model.state_dict().items(),
                         t2.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert set(tckpt.load_checkpoint(tt.save_path, "cpu")) == {
        "params", "opt_state", "step"}


# ---------------------------------------------------------------------------
# the file CLI
# ---------------------------------------------------------------------------


def _header(path):
    with open(path, "rb") as f:
        data = f.read()
    (hlen,) = struct.unpack("<I", data[4:8])
    return json.loads(data[8:8 + hlen]), data[8 + hlen:]


def test_cli_two_level_roundtrip_and_fingerprint(tmp_path):
    """A TwoLevelFlows config through cli.codec (--device cpu): a
    one-tile image and a 20x28 one (2 x 2 tiles of 15x15, one chunk of 4)
    compress and decompress bit-exactly; the header names the twolevel
    pipeline; a container whose fingerprint is the card backend's, or the
    JAX module's variant tag, is refused.  Tolerance: exact."""
    _, _, tm = _pair(PADDED, seed=11)
    ckpt = str(tmp_path / "tl.ckpt")
    tckpt.save_checkpoint(ckpt, {"params": tm.state_dict()})
    cfg_path = tmp_path / "tl.yaml"
    cfg_path.write_text(yaml.safe_dump(json.loads(json.dumps(
        {"train": {"trainer": "TwoLevelTrainer", "model": _tl_dict()}}))))
    rng = np.random.default_rng(12)
    imgs = {"one": rng.integers(0, 256, (15, 15, 3), dtype=np.uint8),
            "four": rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)}
    srcs = []
    for name, arr in imgs.items():
        np.save(tmp_path / f"{name}.npy", arr)
        srcs.append(str(tmp_path / f"{name}.npy"))
    args = ["--config", str(cfg_path), "--ckpt", ckpt, "--outdir",
            str(tmp_path / "out"), "--num-streams", "32", "--device", "cpu",
            "--no-stored-fallback", "--ext", ".npy"]
    C.main(["compress", "--input", *srcs] + args)
    lics = [str(tmp_path / "out" / f"{n}.lic") for n in imgs]
    h, _ = _header(lics[1])
    assert h["pipeline"] == "twolevel" and h["mode"] == "flow"
    assert h["chunks"] == [{"nseg": 2, "info": {"batch": 4}}]
    C.main(["decompress", "--input", *lics] + args)
    for name, arr in imgs.items():
        assert np.array_equal(np.load(tmp_path / "out" / f"{name}.npy"),
                              arr)

    model_cfg = _tl_dict()
    tcfg = ttl.TwoLevelCfg.from_ref(model_cfg)
    tag = C._variant_tag(tcfg, "cpu")
    assert tag.startswith("rough[") and tag.endswith("backend=torch-cpu")
    h, blobs = _header(lics[0])
    assert h["fingerprint"] == C._fingerprint(model_cfg, tag, ckpt)
    from finalproject_losslessimagecompression_tpu.cli import codec as JC

    for other in (C._variant_tag(tcfg, "cuda"), JC._variant_tag(
            jtl.TwoLevelCfg.from_ref(model_cfg))):
        bad = tmp_path / "bad.lic"
        bad.write_bytes(C._container_bytes(
            {**h, "fingerprint": C._fingerprint(model_cfg, other, ckpt)},
            [blobs]))
        with pytest.raises(SystemExit, match="backend"):
            C.main(["decompress", "--input", str(bad)] + args)
