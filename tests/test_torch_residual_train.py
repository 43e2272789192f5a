"""The PyTorch port's VQ-VAE and residual training held against the JAX
package.

The reconstruction likelihoods, one VQ-VAE step (with and without
BatchNorm), the trainer's dead-code reinit, `ResidualTrainer._prepare` and
its loss, eval with real coding for the conditional, unconditional and
`nouse_vqvae` configs, `cli.make_res_data`, JAX checkpoints and the
CLI on the shipped configs.  Inputs are made from numpy seeds and handed to
both packages; flax variables are perturbed (fresh projections are zero)
and loaded into the port through `convert`.  Small size: 16x16x3 images;
VQ-VAE of 16 codewords x 8, hidden dims [8, 16], one ResBlock; flow tiles
8x8, growth 8, depth 2, nflows 2, nsplit 2.  Everything runs on the CPU
(`device="cpu"`).
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from finalproject_losslessimagecompression_tpu.cli import (
    make_res_data as jmake,
)
from finalproject_losslessimagecompression_tpu.models import vqvae as jvq
from finalproject_losslessimagecompression_tpu.ops import (
    distributions as jdist,
)
from finalproject_losslessimagecompression_tpu.train import (
    checkpoint as jckpt,
)
from finalproject_losslessimagecompression_tpu.train import optim as joptim
from finalproject_losslessimagecompression_tpu.train import (
    residual_trainer as jres_trainer,
)
from finalproject_losslessimagecompression_tpu.train import (
    vqvae_trainer as jvq_trainer,
)
from finalproject_losslessimagecompression_tpu_torch import convert
from finalproject_losslessimagecompression_tpu_torch.cli import (
    make_res_data as tmake,
)
from finalproject_losslessimagecompression_tpu_torch.cli import train as tcli
from finalproject_losslessimagecompression_tpu_torch.codec import cuda_rans
from finalproject_losslessimagecompression_tpu_torch.ops import (
    distributions as tdist,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    checkpoint as tckpt,
)
from finalproject_losslessimagecompression_tpu_torch.train.residual_trainer import (  # noqa: E501
    ResidualTrainer,
)
from finalproject_losslessimagecompression_tpu_torch.train.vqvae_trainer import (  # noqa: E501
    VQVAETrainer,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3):
# one call over every thread first keeps that out of the comparisons
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_residual import (  # noqa: E402
    VQ_DICT,
    _flow_dict,
    _grid,
    _np,
    _perturb,
    _vq_pair,
)

LR = 1e-4
BATCH = 4


def _data(seed=1, length=8):
    return dict(name="CustomDataLoader",
                dataset=dict(name="SyntheticImages", size=[16, 16, 3],
                             length=length, seed=seed),
                batch_size=BATCH, nbits=8)


def _common(tmp_path, **over):
    data = _data()
    cfg = dict(train_dataloader={**data, "train": True},
               test_dataloader={**data, "train": False, "shuffle": False},
               scheduler=dict(name="Constant"), max_step=2,
               step_per_epoch=1000, evaluate_interval=1000,
               save_interval=1000, save_path=str(tmp_path / "m.ckpt"),
               writer_path=str(tmp_path / "logs"))
    cfg.update(over)
    return cfg


def _vq_cfg(tmp_path, batch_norm=False, reinit_interval=1000, **over):
    model = dict(VQ_DICT, batch_norm=batch_norm,
                 vectorquantizer=dict(reinit_interval=reinit_interval,
                                      threshold=0.1))
    return _common(tmp_path, model=model, optimizer=dict(name="Adam", lr=LR),
                   train_args=dict(alpha=1.0, beta=0.1, gamma=0.25), **over)


def _logged(path, tag):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in recs if r["tag"] == tag]


def _batch(seed=0):
    return _grid(seed, (BATCH, 16, 16, 3))


# ---------------------------------------------------------------------------
# distributions and the VQ-VAE step
# ---------------------------------------------------------------------------


def test_distributions_match_jax():
    """BinomialDistribution and UnitGaussianDistribution log_prob against
    the JAX package's, on grid inputs and outputs spanning (0, 1) with
    both clip edges.  Tolerance: 1e-5 relative, for the Binomial relative
    to lgamma(256) ~ 1124 elementwise (its log coefficient is a float32
    difference of lgamma terms that large, whose last bits torch.lgamma
    and jax's gammaln round differently) and to the value for the mean,
    the loss the trainer takes."""
    rng = np.random.default_rng(3)
    x = _grid(4, (2000,))
    y = rng.uniform(0, 1, 2000).astype(np.float32)
    y[:3] = [0.0, 1.0, 1e-9]
    for name, atol in (("BinomialDistribution", 1e-5 * math.lgamma(256.0)),
                       ("UnitGaussianDistribution", 0.0)):
        got = _np(tdist.DISTRIBUTIONS.get(name)().log_prob(
            torch.from_numpy(x), torch.from_numpy(y)))
        want = np.asarray(jdist.DISTRIBUTIONS.get(name)().log_prob(
            jnp.asarray(x), jnp.asarray(y)))
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
        np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-5)


def _sign_rule(got, want, g, gmax, lr):
    """Parameters after one Adam step (each moves by about lr * sign(g)):
    within 1e-5, except where |g| is within the two backends' gradient
    noise of zero (1e-4 of the model's largest, gmax) and the step's sign
    may differ, by at most 2 lr.  Returns the count of such elements."""
    near = np.abs(g) <= 1e-4 * gmax
    off = np.abs(got - want) > 1e-5
    assert not np.any(off & ~near), float(np.abs(got - want)[~near].max())
    assert np.all(np.abs(got - want) <= 2 * lr + 1e-5)
    return int(off.sum())


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
def test_vqvae_step_matches_jax(batch_norm, tmp_path):
    """One step of the port's VQVAETrainer against make_vqvae_step on the
    same variables and batch: recloss and vqloss within 1e-5 relative,
    counts exact (power-of-two vector count, every index equal), params
    after one Adam step within 1e-5 (`_sign_rule`: at most 0.2% of
    elements off, each where the gradient is ~0), BatchNorm running
    averages within 1e-5, and the optax moments carried over by
    opt_state_from_optax with the VQ-VAE converter within 1e-5 of the
    port's."""
    jm, var, _ = _vq_pair(batch_norm, seed=50)
    jopt = joptim.build_optimizer(dict(name="Adam", lr=LR),
                                  dict(name="Constant"), 1000)
    step, _, _ = jvq_trainer.make_vqvae_step(jm, jopt, 1.0, 0.1, 0.25)
    jvar = jax.tree_util.tree_map(jnp.asarray, var)
    x = _batch(51)
    jp, jst, jloss, (jrec, jvqloss, jcounts, jflat) = step(
        jvar, jopt.init(jvar), jnp.asarray(x))
    tt = VQVAETrainer(**_vq_cfg(tmp_path, batch_norm), device="cpu")
    tt.model.load_state_dict(convert.vqvae_params_from_flax(var))
    loss, rec, vqloss, counts, flat = tt.train_step(torch.from_numpy(x))
    np.testing.assert_allclose(float(rec), float(jrec), rtol=1e-5)
    np.testing.assert_allclose(float(vqloss), float(jvqloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert np.array_equal(_np(counts), np.asarray(jcounts))
    np.testing.assert_allclose(_np(flat), np.asarray(jflat), atol=1e-5)

    g = convert.vqvae_params_from_flax(jax.device_get(jax.grad(
        _jax_loss(jm, batch_norm))(jvar, jnp.asarray(x))))
    want = convert.vqvae_params_from_flax(jax.device_get(jp))
    gmax = max(float(v.abs().max()) for v in g.values())
    flips = sum(_sign_rule(_np(p), want[n].numpy(), g[n].numpy(), gmax, LR)
                for n, p in tt.model.named_parameters())
    total = sum(p.numel() for p in tt.model.parameters())
    # with BatchNorm the biases of the convs that feed it have a true
    # gradient of exactly zero (the batch mean takes them out), so both
    # backends step on noise there
    assert flips <= 0.002 * total, (flips, total)
    for n, b in tt.model.named_buffers():  # BatchNorm running averages
        np.testing.assert_allclose(_np(b), want[n].numpy(), rtol=0,
                                   atol=1e-5)
    assert bool(list(tt.model.named_buffers())) == batch_norm

    names = [n for n, _ in tt.model.named_parameters()]
    moved = convert.opt_state_from_optax(jax.device_get(jst), names, "Adam",
                                         convert.vqvae_params_from_flax)
    assert moved["count"] == tt.optimizer.count == 1
    mine = tt.optimizer.state_dict()["state"]
    for i in mine:
        np.testing.assert_allclose(_np(mine[i]["exp_avg"]),
                                   _np(moved["state"][i]["exp_avg"]),
                                   rtol=0, atol=1e-5)


def _jax_loss(jm, batch_norm):
    """make_vqvae_step's loss as a function of the variables."""
    dist = jdist.BinomialDistribution()

    def loss(v, batch):
        if batch_norm:
            (out, vqloss, _, _), _ = jm.apply(
                v, (batch - 0.5) / 0.5, 0.1, 0.25, True,
                mutable=["batch_stats"])
        else:
            out, vqloss, _, _ = jm.apply(v, (batch - 0.5) / 0.5, 0.1, 0.25)
        rec = -jnp.mean(dist.log_prob(batch, out * 0.5 + 0.5))
        return rec + vqloss

    return loss


def test_vqvae_trainer_reinit_log_and_resume(tmp_path, capsys):
    """The trainer's reinit replaces the codewords JAX's vq_reinit replaces
    on the same codebook, counts and vectors (exact); over a run with
    reinit_interval 3 it fires, is reported at the log cadence only
    (log_every 2: scalars at steps 2 and 4), and a checkpoint resumes
    params, optimizer state, step and counts bit for bit; eval gives a
    finite bpd and [4, 16, 16, 3] reconstructions."""
    tt = VQVAETrainer(**_vq_cfg(tmp_path, reinit_interval=3, max_step=4,
                                log_every=2, evaluate_interval=4,
                                save_interval=4), device="cpu")
    _, _, _, counts, flat = tt.train_step(torch.from_numpy(_batch(60)))
    tt.counts = tt.counts + counts
    tt.counts[0] += 3.5  # past the interval, the unused codewords low
    cb, total = _np(tt.model.vq.codebook).copy(), _np(tt.counts).copy()
    did, nrep = tt.reinit(flat)
    want = jvq.vq_reinit(jnp.asarray(cb), jnp.asarray(total),
                         jnp.asarray(_np(flat)), 3.0, 0.1)
    assert bool(did) and bool(want[2]) and int(nrep) == int(want[3]) > 0
    assert np.array_equal(_np(tt.model.vq.codebook), np.asarray(want[0]))
    assert np.array_equal(_np(tt.counts), np.asarray(want[1]))
    assert int(tt.replaced) == int(nrep)

    tt.train()
    assert [s for s, _ in _logged(tmp_path / "logs", "train bpd")] == [2, 4]
    for tag in ("train loss", "train recloss", "train vqloss", "test bpd"):
        assert all(np.isfinite(v) for _, v in _logged(tmp_path / "logs",
                                                      tag)), tag
    # the train steps' counts pass 3 at step 4, a log step
    assert "vq re-init: replaced" in capsys.readouterr().out
    assert int(tt.replaced) > int(nrep)
    bpd, recon = tt.evaluate()
    assert np.isfinite(bpd) and recon.shape == (BATCH, 16, 16, 3)
    raw = tckpt.load_checkpoint(tt.save_path, "cpu")
    assert set(raw) == {"params", "opt_state", "step", "counts"}
    cfg = _vq_cfg(tmp_path / "b")
    cfg["model"] = dict(cfg["model"], load_path=tt.save_path)
    t2 = VQVAETrainer(**cfg, device="cpu")
    assert t2.step == 4 and torch.equal(t2.counts, tt.counts)
    # the manual step above and the loop's four
    assert t2.optimizer.count == tt.optimizer.count == 5
    for (n, a), b in zip(tt.model.state_dict().items(),
                         t2.model.state_dict().values()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# residual trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vq_ckpts(tmp_path_factory):
    """(JAX msgpack checkpoint, port checkpoint) of the same perturbed
    VQ-VAE variables, and the variables."""
    tmp = tmp_path_factory.mktemp("vq")
    _, var, _ = _vq_pair(seed=70)
    jpath, tpath = str(tmp / "vq.msgpack"), str(tmp / "vq.ckpt")
    jckpt.save_checkpoint(jpath, {"params": var})
    tckpt.save_checkpoint(tpath, {"params": convert.vqvae_params_from_flax(
        var)})
    return jpath, tpath, var


def _res_cfg(tmp_path, vq_ckpt, name="ConditionalFlows", **over):
    cfg = dict(flows=dict(_flow_dict(True), name=name),
               vqvae={**VQ_DICT, "checkpoint": vq_ckpt},
               input_size=[16, 16], patch_batch_size=0,
               optimizer=dict(name="Adamax", lr=1e-3), num_streams=32)
    cfg.update(over)
    return _common(tmp_path, **cfg)


def test_residual_prepare_and_loss_match_jax(vq_ckpts, tmp_path):
    """ResidualTrainer._prepare (VQ reconstruction, grid rounding, residual,
    patches of both) and the eval loss against the JAX ResidualTrainer's
    on the same weights and batch: patches equal except counted rounding
    ties (<= 0.1% of elements), loss within 1e-5 relative."""
    jpath, tpath, _ = vq_ckpts
    jt = jres_trainer.ResidualTrainer(**_res_cfg(tmp_path / "j", jpath))
    params = _perturb(jt.params, 71)
    tt = ResidualTrainer(**_res_cfg(tmp_path, tpath), device="cpu")
    tt.model.load_state_dict(convert.params_from_flax(params))
    x = _batch(72)
    jpatch, jrec_patch, jrec = jt._prepare(jnp.asarray(x))
    patch, rec_patch, rec = tt._prepare(torch.from_numpy(x))
    for a, b in ((patch, jpatch), (rec_patch, jrec_patch), (rec, jrec)):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape
        ties = np.count_nonzero(a != b)
        assert ties <= 0.001 * a.size, ties
        assert np.abs(a - b).max() <= 1 / 256 + 1e-7
    assert np.array_equal(_np(patch + rec_patch),
                          np.asarray(jres_trainer.patch_split(x, 8, 8)))
    jloss = jt.eval_step(params, jnp.asarray(x))[0]
    loss = tt.eval_step(torch.from_numpy(x))[0]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("kind", ["conditional", "unconditional",
                                  "nouse_vqvae"])
def test_residual_eval_with_coding(vq_ckpts, tmp_path, kind):
    """Two steps then evaluate with test_coding on the CPU: 0 coding
    errors, rec_error ~ 0 (the inverse flow returns the residual), a
    finite real bpd, and no rANS kernel launched; the conditional config
    codes through ResidualCodec (index stream included), the others
    through FlowCodec.  The unconditional run also draws a patch subset
    (patch_batch_size 2).  Tolerance: exact."""
    _, tpath, _ = vq_ckpts
    over = dict(test_coding=True, max_eval_batches=1)
    if kind == "conditional":
        cfg = _res_cfg(tmp_path, tpath, **over)
    elif kind == "unconditional":
        cfg = _res_cfg(tmp_path, tpath, "IDFlows", patch_batch_size=2,
                       **over)
    else:
        cfg = _res_cfg(tmp_path, tpath, "IDFlows", nouse_vqvae=True,
                       vqvae={}, **over)
    tt = ResidualTrainer(**cfg, device="cpu")
    assert (tt.res_codec is not None) == (kind == "conditional")
    launches = cuda_rans.rans_decode.launches
    tt.train()
    ev = tt.evaluate()
    assert ev["coding_errors"] == 0
    assert ev["rec_error"] < 1e-4
    assert np.isfinite(ev["real_bpd"]) and ev["real_bpd"] > 0
    assert cuda_rans.rans_decode.launches == launches
    assert ev["images"]["rec_img"].shape == (BATCH, 16, 16, 3)
    assert ("rec" in ev["images"]) == (kind != "nouse_vqvae")


def test_residual_guard_cadence_and_resume(vq_ckpts, tmp_path):
    """A conditional flow without the VQ-VAE raises ValueError; log_every
    2 over 4 steps logs the train scalars at steps 2 and 4 only; a resumed
    trainer holds the saved params, optimizer state and step."""
    _, tpath, _ = vq_ckpts
    with pytest.raises(ValueError, match="VQ-VAE"):
        ResidualTrainer(**_res_cfg(tmp_path, tpath, nouse_vqvae=True),
                        device="cpu")
    tt = ResidualTrainer(**_res_cfg(tmp_path, tpath, max_step=4,
                                    log_every=2), device="cpu")
    tt.train()
    assert [s for s, _ in _logged(tmp_path / "logs", "train bpd")] == [2, 4]
    assert [s for s, _ in _logged(tmp_path / "logs", "step time s")] == [4]
    cfg = _res_cfg(tmp_path / "b", tpath)
    cfg["flows"] = dict(cfg["flows"], load_path=tt.save_path)
    t2 = ResidualTrainer(**cfg, device="cpu")
    assert t2.step == 4 and t2.optimizer.count == 4
    for (n, a), b in zip(tt.model.state_dict().items(),
                         t2.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_msgpack_checkpoint_is_refused(vq_ckpts, tmp_path):
    """A JAX (msgpack) checkpoint is refused only without a converter:
    load_params with none raises ValueError asking for the model's
    converter; with vqvae_params_from_flax it returns the port
    checkpoint's params bit for bit, and a ResidualTrainer pointed at the
    JAX file holds the same frozen VQ-VAE as one pointed at the port's."""
    jpath, tpath, _ = vq_ckpts
    with pytest.raises(ValueError, match="converter"):
        tckpt.load_params(jpath, "cpu")
    got = tckpt.load_params(jpath, "cpu", convert.vqvae_params_from_flax)
    want = tckpt.load_params(tpath, "cpu")
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    tj = ResidualTrainer(**_res_cfg(tmp_path / "j", jpath), device="cpu")
    tt = ResidualTrainer(**_res_cfg(tmp_path / "t", tpath), device="cpu")
    for (n, a), b in zip(tj.vqvae.state_dict().items(),
                         tt.vqvae.state_dict().values()):
        assert torch.equal(a, b), n


def test_make_res_data_matches_jax(vq_ckpts, tmp_path):
    """cli.make_res_data (the port's, --device cpu) writes the npz the JAX
    module writes from the same VQ-VAE weights and loader: residual and
    reconstruction equal except counted rounding ties (<= 0.1%), and
    residual + reconstruction is the loader's batches exactly."""
    jpath, tpath, _ = vq_ckpts
    outs = {}
    for pkg, ckpt, main in (("jax", jpath, jmake.main),
                            ("torch", tpath, tmake.main)):
        cfg = {"train": _res_cfg(tmp_path, ckpt)}
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
        out = str(tmp_path / f"{pkg}.npz")
        extra = ["--device", "cpu"] if pkg == "torch" else []
        main(["--config", str(path), "--out", out, "--max-batches", "2",
              "--split", "train_dataloader"] + extra)
        outs[pkg] = np.load(out)
    got, want = outs["torch"], outs["jax"]
    for key in ("residual", "reconstruction"):
        assert got[key].shape == want[key].shape == (2 * BATCH, 16, 16, 3)
        assert np.count_nonzero(got[key] != want[key]) <= \
            0.001 * got[key].size
    loader = tmake.build(tmake.DATALOADERS, {**_data(), "train": True})
    data = np.concatenate([next(loader), next(loader)])
    assert np.array_equal(got["residual"] + got["reconstruction"], data)
    assert np.array_equal(np.round(got["reconstruction"] * 256),
                          got["reconstruction"] * 256)


# ---------------------------------------------------------------------------
# the CLI on the shipped configs
# ---------------------------------------------------------------------------


def _cli_sets(tmp_path, key, data_path):
    """--set overrides: the loaders' `key` (their data path) to data_path,
    batch 1, paths under tmp_path, one step, no eval."""
    sets = []
    for split in ("train_dataloader", "test_dataloader"):
        sets += [f"train.{split}.{key}={data_path}",
                 f"train.{split}.batch_size=1"]
    sets += ["train.max_step=1", "train.log_every=1",
             f"train.save_path={tmp_path / 'm.ckpt'}",
             f"train.writer_path={tmp_path / 'log'}"]
    return [a for s in sets for a in ("--set", s)]


def test_cli_train_runs_the_new_configs(vq_ckpts, tmp_path):
    """cli.train.main with --device cpu and --set overrides (the data path,
    checkpoint and log paths, narrower widths) builds and trains one step
    of the shipped VQ-VAE, residual and two-level configs, on ImageNet64
    npz batches and a folder of 215x178 PNGs made here, and each writes a
    checkpoint that loads."""
    from PIL import Image

    _, tpath, _ = vq_ckpts
    rng = np.random.default_rng(80)
    npz = tmp_path / "imagenet64"
    npz.mkdir()
    for name in ("train_data_batch_1.npz", "val_data.npz"):
        np.savez(npz / name, data=rng.integers(0, 256, (2, 3 * 64 * 64),
                                               dtype=np.uint8))
    pngs = tmp_path / "celeba"
    pngs.mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (215, 178, 3), dtype=np.uint8)
                        ).save(pngs / f"{i}.png")
    narrow_flow = ["nflows=1", "couple.nn.growth_channel=4",
                   "couple.nn.depth=1", "prior.nn.growth_channel=4",
                   "prior.nn.depth=1"]
    runs = {
        "vqvae_for_imagenet64_reinit.yaml": (
            "VQVAETrainer", "dataset.path", npz,
            ["train.model.encoder.block_num=1",
             "train.model.decoder.block_num=1", "train.model.embed_num=16",
             "train.model.embed_dim=8", "train.model.hidden_dims=[8, 8, 8]"]),
        "resflow-cond-imagenet64.yaml": (
            "ResidualTrainer", "dataset.path", npz,
            [f"train.flows.{s}" for s in narrow_flow]
            + ["train.flows.nsplit=1", f"train.vqvae.checkpoint={tpath}"]
            + [f"train.vqvae.{k}" for k in (
                "encoder.block_num=1", "decoder.block_num=1", "embed_num=16",
                "embed_dim=8", "hidden_dims=[8, 16]")]),
        "config_twolevel.yaml": (
            "TwoLevelTrainer", "path", pngs,
            [f"train.model.{f}.{s}" for f in ("rough_flows", "fine_flows")
             for s in narrow_flow]),
    }
    for name, (trainer, key, data, narrow) in runs.items():
        d = tmp_path / trainer
        t = tcli.main(["--config", os.path.join(REPO, "configs", name),
                       "--device", "cpu"] + _cli_sets(d, key, data)
                      + [a for s in narrow for a in ("--set", s)])
        assert type(t).__name__ == trainer and t.step == 1
        assert tckpt.load_checkpoint(str(d / "m.ckpt"), "cpu")["step"] == 1
