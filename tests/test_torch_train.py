"""The PyTorch port's training path held against the JAX package.

Datasets, loader, schedule, optimizers, the loss and its gradients, the
trainer's steps, optimizer-state carry-over, checkpoints, eval with real
coding, sampling and the CLI.  Inputs are made from numpy seeds and handed
to both packages; the flax parameters are perturbed (fresh projections are
zero) and loaded into the port through `convert.params_from_flax`.  Small
size: 16x16x3 images, nflows 2, nsplit 2, DenseBlocks of growth 8 and depth
2, batch 4.  Everything runs on the CPU (`device="cpu"`).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from finalproject_losslessimagecompression_tpu.cli import train as jcli
from finalproject_losslessimagecompression_tpu.data import datasets as jds
from finalproject_losslessimagecompression_tpu.data import loader as jloader
from finalproject_losslessimagecompression_tpu.models import idflow as jidflow
from finalproject_losslessimagecompression_tpu.train import optim as joptim
from finalproject_losslessimagecompression_tpu.train import trainer as jtrainer
from finalproject_losslessimagecompression_tpu_torch.cli import train as tcli
from finalproject_losslessimagecompression_tpu_torch.cli import yamlite
from finalproject_losslessimagecompression_tpu_torch.convert import (
    opt_state_from_optax,
    params_from_flax,
)
from finalproject_losslessimagecompression_tpu_torch.data import (
    datasets as tds,
)
from finalproject_losslessimagecompression_tpu_torch.data import (
    loader as tloader,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    checkpoint as tckpt,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    optim as toptim,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    trainer as ttrainer,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# a process's first parallel CPU exp can be inaccurate (test_torch_flow.py)
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
BATCH = 4


def train_cfg(tmp_path, **over):
    """The `train` subtree both trainers take."""
    nn = dict(name="DenseBlock", growth_channel=8, depth=2,
              layer=dict(name="DenseLayer", act="ReLU"))
    rnd = dict(name="Round", nbits=8)
    data = dict(name="CustomDataLoader",
                dataset=dict(name="SyntheticImages", size=[16, 16, 3],
                             length=8, seed=1),
                batch_size=BATCH, nbits=8)
    cfg = dict(
        model=dict(name="IDFlows", nflows=2, nbits=8, nsplit=2, H=16, W=16,
                   C=3, couple=dict(name="AdditiveCouple", split=0.75, nn=nn,
                                    round=rnd),
                   extenddim=dict(name="ExtendDim", scale=2),
                   prior=dict(name="Prior", round=rnd, nn=nn),
                   distribution=dict(name="DLogistic"), round=rnd),
        test_coding=False,
        train_dataloader={**data, "train": True},
        test_dataloader={**data, "train": False, "shuffle": False},
        optimizer=dict(name="Adamax", lr=LR),
        scheduler=dict(name="WarmUpScheduler", warmup=2, beta=0.99),
        max_step=3, step_per_epoch=1000, evaluate_interval=1000,
        save_interval=1000, save_path=str(tmp_path / "model.ckpt"),
        writer_path=str(tmp_path / "logs"),
    )
    cfg.update(over)
    return cfg


def perturbed(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, np.shape(a))
                   ).astype(np.float32), jax.device_get(params))


def port_trainer(tmp_path, params, **over):
    tt = ttrainer.Trainer(**train_cfg(tmp_path, **over), device="cpu")
    tt.model.load_state_dict(params_from_flax(params))
    return tt


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """A JAX Trainer (its jitted steps compile once for the module) and
    perturbed flax params."""
    jt = jtrainer.Trainer(**train_cfg(tmp_path_factory.mktemp("jax")))
    return jt, perturbed(jt.params)


def reset(jt, params):
    """Point the JAX trainer at fresh copies of `params`, step 0."""
    jt.params = jax.tree_util.tree_map(jnp.array, params)
    jt.opt_state = jt.optimizer.init(jt.params)
    jt.step = 0


def batch_np(seed=0):
    return np.asarray(next(iter(tloader.CustomDataLoader(
        dict(name="SyntheticImages", size=[16, 16, 3], length=8, seed=seed),
        BATCH, shuffle=False))))


def logged(path, tag):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in recs if r["tag"] == tag]


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_datasets_and_loader_match_jax():
    """SyntheticImages and NaturalSynthetic items, padded and grid-rounded
    batches, the seeded shuffle over two epochs of a cycling loader, and
    shard views equal the JAX package's.  Tolerance: exact."""
    for name, kw in (("SyntheticImages", dict(size=(6, 5, 3), length=5)),
                     ("NaturalSynthetic", dict(size=(8, 8, 3), length=3))):
        a, b = getattr(tds, name)(seed=2, **kw), getattr(jds, name)(seed=2,
                                                                    **kw)
        assert all(np.array_equal(a[i], b[i]) for i in range(len(a)))
    cached = tds.CachedDataset(tds.SyntheticImages(size=(4, 4, 3), length=3))
    assert np.array_equal(cached[2], jds.SyntheticImages(
        size=(4, 4, 3), length=3)[2])

    def batches(mod, n, **kw):
        loader = tloader if mod is tds else jloader
        dl = loader.DataLoader(mod.SyntheticImages((6, 6, 3), 5, 0), **kw)
        return [next(dl) for _ in range(n)]

    for kw in (dict(batch_size=2, pad=(2, 1), train=True, seed=4),
               dict(batch_size=3, train=True, shard_index=1, shard_count=2),
               dict(batch_size=2, shuffle=False, train=True)):
        got, want = batches(tds, 7, **kw), batches(jds, 7, **kw)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert got[0].shape[1:3] == (6 + kw.get("pad", (0, 0))[0],
                                     6 + kw.get("pad", (0, 0))[1])
    # shard: true without torch.distributed is the whole dataset
    dl = tloader.CustomDataLoader(
        dict(name="SyntheticImages", size=[4, 4, 3], length=5), 2,
        shuffle=False, shard=True)
    assert (dl.shard_index, dl.shard_count) == (0, 1)
    assert sum(len(b) for b in iter(dl)) == 5


def test_shard_true_takes_torch_distributed_coordinates(monkeypatch):
    """With torch.distributed initialised, `shard: true` draws rank 1 of 2's
    stride of each epoch, the batches the JAX loader gives for
    shard_index=1, shard_count=2.  Tolerance: exact."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    ds = dict(name="SyntheticImages", size=[4, 4, 3], length=7, seed=3)
    dl = tloader.CustomDataLoader(ds, 2, train=True, seed=5, shard=True)
    ref = jloader.CustomDataLoader(ds, 2, train=True, seed=5, shard_index=1,
                                   shard_count=2)
    assert (dl.shard_index, dl.shard_count) == (1, 2)
    for _ in range(5):
        assert np.array_equal(next(dl), next(ref))


# ---------------------------------------------------------------------------
# schedule and optimizers
# ---------------------------------------------------------------------------


def test_schedule_matches_jax():
    """warmup_exp_schedule and Constant against the JAX package's at update
    counts across the warmup and the decay.  Tolerance: 1e-6 relative (the
    JAX schedule computes in float32)."""
    for args in ((1e-3, 10, 0.99, 1000), (0.5, 2, 0.9, 3), (1.0, 1, 0.995, 1)):
        t = toptim.warmup_exp_schedule(*args)
        j = joptim.warmup_exp_schedule(*args)
        for count in (0, 1, 2, 5, 999, 1000, 2999, 10_000, 123_457):
            np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6)
    assert toptim.SCHEDULERS.get("Constant")(0.3, 10)(77) == 0.3


OPTIMIZERS = {
    "adamax": (dict(name="Adamax", lr=0.1), None),
    "adam": (dict(name="Adam", lr=0.1), None),
    "sgd": (dict(name="SGD", lr=0.1), None),
    "sgd_momentum": (dict(name="SGD", lr=0.1, momentum=0.9), None),
    "adamax_clip": (dict(name="Adamax", lr=0.1, grad_clip_norm=2.0), None),
    "adam_b1b2_clip": (dict(name="Adam", lr=0.1, b1=0.8, b2=0.99,
                            grad_clip_norm=2.0), None),
}


@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(key):
    """Three updates of the port's optimizer (torch.optim, lr from the
    warmup schedule at the update count, optax's global-norm clip) against
    the JAX package's optax chain, on gradients that include exact zeros,
    1e-12 entries and steps above and below the clip norm.  Tolerance:
    parameters and moments 1e-6 relative to each tensor's largest value
    (an element that three updates of 0.1 carry through zero keeps the
    float32 ulps of its larger past values)."""
    ocfg, _ = OPTIMIZERS[key]
    sched = dict(name="WarmUpScheduler", warmup=2, beta=0.9)
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    p0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for step, scale in enumerate((3.0, 0.1, 1.0)):
        g = {k: (scale * rng.normal(0, 1, s)).astype(np.float32)
             for k, s in shapes.items()}
        g["a"][0] = 0.0
        g["a"][1, :2] = 1e-12
        g["b"][step] = 0.0
        grads.append(g)
    jopt = joptim.build_optimizer(ocfg, sched, step_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jopt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in shapes]
    topt = toptim.build_optimizer(tp, ocfg, sched, step_per_epoch=1)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))

    for g in grads:
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tp, shapes):
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for p, k in zip(tp, shapes):
            close(_np(p), jp[k])
    assert topt.count == 3
    inner = jax.device_get(jst)
    adam = [s for s in jax.tree_util.tree_leaves(
        inner, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu")]
    if adam:
        second = "exp_inf" if ocfg["name"] == "Adamax" else "exp_avg_sq"
        for i, k in enumerate(shapes):
            st = topt.inner.state[tp[i]]
            close(_np(st["exp_avg"]), adam[0].mu[k])
            close(_np(st[second]), adam[0].nu[k])


def test_clip_is_optax_not_torch():
    """The clip scales by max_norm / ||g|| exactly (optax), not by
    max_norm / (||g|| + 1e-6) (torch's clip_grad_norm_), and leaves a
    gradient under the norm untouched.  Tolerance: exact for the untouched
    case, 1 ulp for the clipped one."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = toptim.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 5.0
    want = np.asarray(optax.clip_by_global_norm(1.0).update(
        [jnp.array([3.0, 4.0]), jnp.array([0.0])], None)[0][0])
    np.testing.assert_allclose(_np(g[0]), want, rtol=1.2e-7, atol=0)
    small = [torch.tensor([0.3, 0.4])]
    toptim.clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.tensor([0.3, 0.4]))


# ---------------------------------------------------------------------------
# loss, gradients, one step
# ---------------------------------------------------------------------------


def _clamp_ties(tt, batch):
    """(clamp ties, elements): latent elements whose logscale sits exactly
    on the prior's floor or whose log-sigmoid difference is exactly 0 --
    where JAX splits a clamp's gradient and torch passes all of it."""
    ties = total = 0
    with torch.no_grad():
        lat, means, logscales = tt.model(batch)
        for z, m, ls, prior in zip(lat, means, logscales, tt.model.priors):
            s = torch.exp(ls)
            half = 0.5 / 256
            lfp = torch.nn.functional.logsigmoid((z + half - m) / s)
            lfn = torch.nn.functional.logsigmoid((z - half - m) / s)
            ties += int((ls == prior.logscale_min).sum())
            ties += int((lfn - lfp == 0).sum())
            total += z.numel()
    return ties, total


def test_loss_and_aux_match_jax(jax_side, tmp_path):
    """The port's loss_fn against the JAX trainer's (make_train_step's
    loss_fn): loss, per-split bpd within 1e-4 relative; max_z and min_z
    within one grid step, with latent rounding ties counted at <= 0.1%."""
    jt, params = jax_side
    tt = port_trainer(tmp_path, params)
    x = batch_np()
    jloss, jaux = jt.eval_step(params, jnp.asarray(x))
    tloss, taux = tt.eval_step(torch.from_numpy(x))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(_np(taux["per_split_bpd"]),
                               np.asarray(jaux["per_split_bpd"]), rtol=1e-4)
    for k in ("max_z", "min_z"):
        assert np.abs(_np(taux[k]) - np.asarray(jaux[k])).max() <= 1.0
    jl, _, _ = jt.model.apply(params, jnp.asarray(x))
    with torch.no_grad():
        tl, _, _ = tt.model(torch.from_numpy(x))
    off = sum(int(np.count_nonzero(np.asarray(a) != _np(b)))
              for a, b in zip(jl, tl))
    assert off <= 0.001 * sum(a.size for a in jl), off


def _jax_grads(jt, params, x):
    return jax.device_get(jax.grad(
        lambda p: jt.eval_step(p, jnp.asarray(x))[0])(params))


def test_gradients_match_jax(jax_side, tmp_path):
    """Per-tensor gradients of the loss: ||g_port - g_jax||_inf <=
    1e-3 * ||g_jax||_inf + 1e-7 (conv summation order; straight-through
    rounding ties), with clamp ties counted at <= 0.1% of latents."""
    jt, params = jax_side
    tt = port_trainer(tmp_path, params)
    x = batch_np()
    want = params_from_flax(_jax_grads(jt, params, x))
    loss, _ = tt.loss_fn(torch.from_numpy(x))
    loss.backward()
    ties, total = _clamp_ties(tt, torch.from_numpy(x))
    assert ties <= 0.001 * total, (ties, total)
    for name, p in tt.model.named_parameters():
        w = want[name].numpy()
        err = np.abs(_np(p.grad) - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-7, (name, err, ties)


def _sign_rule(got, want, g, p0, lr):
    """Parameters after Adamax updates: where |g| is well above the noise
    of two backends' gradients, they agree within 2e-3 * lr + 1e-6 |p|;
    elsewhere the step's sign may differ, so they differ by at most
    2 * lr.  Returns how far the reference moved the tensor."""
    noise = 1e-3 * np.abs(g).max() + 1e-7
    big = np.abs(g) > 10 * noise
    d = np.abs(got - want)
    tol = 2e-3 * lr + 1e-6 * np.abs(want)
    assert np.all(d[big] <= tol[big]), float(d[big].max())
    assert np.all(d <= 2 * lr + 1e-6 * np.abs(want)), float(d.max())
    return float(np.abs(want - p0).max())


def test_one_adamax_step_matches_jax(jax_side, tmp_path):
    """Parameters after one Adamax step of each trainer from the same
    params and batch, under the sign rule (`_sign_rule`)."""
    jt, params = jax_side
    reset(jt, params)
    tt = port_trainer(tmp_path, params)
    x = batch_np()
    g = params_from_flax(_jax_grads(jt, params, x))
    jp, _, _, _ = jt.train_step(jt.params, jt.opt_state, jnp.asarray(x))
    want = params_from_flax(jax.device_get(jp))
    tt.train_step(torch.from_numpy(x))
    p0 = params_from_flax(params)
    lr = toptim.warmup_exp_schedule(LR, 2, 0.99, 1000)(0)
    moved = [_sign_rule(_np(p), want[name].numpy(), g[name].numpy(),
                        p0[name].numpy(), lr)
             for name, p in tt.model.named_parameters()]
    assert max(moved) > 0.5 * lr  # the step did move the parameters


def test_trainers_agree_over_three_steps(jax_side, tmp_path):
    """The JAX Trainer and the port's, from the same params and config:
    per-step train losses over 3 steps within 1e-3 relative (after step 1
    the sign rule lets low-gradient parameters drift by 2 * lr), and the
    test_bpd of `evaluate` afterwards within 1e-3 relative."""
    jt, params = jax_side
    reset(jt, params)
    jt.writer = jtrainer.MetricsWriter(str(tmp_path / "jlogs"))
    jt.train()
    tt = port_trainer(tmp_path, params)
    tt.train()
    jl = logged(tmp_path / "jlogs", "train loss")
    tl = logged(tmp_path / "logs", "train loss")
    assert [s for s, _ in tl] == [s for s, _ in jl] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl],
                               rtol=1e-3)
    assert tt.optimizer.count == 3 and tt.step == 3
    np.testing.assert_allclose(tt.evaluate()["test_bpd"],
                               jt.evaluate()["test_bpd"], rtol=1e-3)


def test_optax_state_carries_over(jax_side, tmp_path):
    """JAX 2 steps equal JAX 1 step -> params_from_flax and
    opt_state_from_optax -> port 1 step, under the sign rule; the port's
    update count continues from optax's."""
    jt, params = jax_side
    reset(jt, params)
    x1, x2 = batch_np(0), batch_np(3)
    p1, s1, _, _ = jt.train_step(jt.params, jt.opt_state, jnp.asarray(x1))
    p1, s1 = jax.device_get(p1), jax.device_get(s1)
    g2 = params_from_flax(_jax_grads(jt, p1, x2))
    p2, _, _, _ = jt.train_step(jax.tree_util.tree_map(jnp.array, p1),
                                jax.tree_util.tree_map(jnp.array, s1),
                                jnp.asarray(x2))
    want = params_from_flax(jax.device_get(p2))
    tt = port_trainer(tmp_path, p1)
    names = [n for n, _ in tt.model.named_parameters()]
    tt.optimizer.load_state_dict(opt_state_from_optax(s1, names))
    assert tt.optimizer.count == 1
    tt.train_step(torch.from_numpy(x2))
    assert tt.optimizer.count == 2
    before = params_from_flax(p1)
    lr = toptim.warmup_exp_schedule(LR, 2, 0.99, 1000)(1)
    moved = [_sign_rule(_np(p), want[name].numpy(), g2[name].numpy(),
                        before[name].numpy(), lr)
             for name, p in tt.model.named_parameters()]
    assert max(moved) > 0.5 * lr
    with pytest.raises(ValueError):
        opt_state_from_optax(s1, names, name="SGD")


# ---------------------------------------------------------------------------
# the loop, checkpoints, eval, sampling
# ---------------------------------------------------------------------------


def test_k_block_logs_resumes_and_realigns(jax_side, tmp_path):
    """K = 2 steps per block log every step's loss; an interval that is not
    a multiple of K raises; a resume at step 3 under K = 2 realigns the
    step to 2 while the update count stays 3, and the learning rate of
    each later update is the schedule at the update count.  Tolerance:
    exact."""
    _, params = jax_side
    tt = port_trainer(tmp_path, params, max_step=4, steps_per_dispatch=2,
                      step_per_epoch=2, evaluate_interval=4, save_interval=4,
                      scheduler=dict(name="WarmUpScheduler", warmup=2,
                                     beta=0.9))
    tt.train()
    assert [s for s, _ in logged(tmp_path / "logs", "train bpd")] == [
        1, 2, 3, 4]
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        port_trainer(tmp_path, params, steps_per_dispatch=3)

    sched = dict(name="WarmUpScheduler", warmup=2, beta=0.9)
    t1 = port_trainer(tmp_path / "a", params, max_step=3, step_per_epoch=1,
                      scheduler=sched)
    t1.train()
    t2 = ttrainer.Trainer(**train_cfg(
        tmp_path / "a", max_step=4, step_per_epoch=2, steps_per_dispatch=2,
        evaluate_interval=4, save_interval=4, scheduler=sched,
        model=dict(train_cfg(tmp_path)["model"],
                   load_path=str(tmp_path / "a" / "model.ckpt"))),
        device="cpu")
    assert (t2.step, t2.optimizer.count) == (2, 3)
    sch = toptim.warmup_exp_schedule(LR, 2, 0.9, 2)
    assert t2.optimizer.lr() == sch(3)
    t2.train()
    assert (t2.step, t2.optimizer.count) == (4, 5)
    assert t2.optimizer.inner.param_groups[0]["lr"] == sch(4)


def test_checkpoint_roundtrip_and_rescue(jax_side, tmp_path, monkeypatch):
    """save then load gives bitwise-equal params, optimizer state and step;
    an exception inside the loop writes a rescue checkpoint of the state
    it reached and re-raises.  Tolerance: exact."""
    _, params = jax_side
    tt = port_trainer(tmp_path, params, max_step=2)
    tt.train()
    t2 = port_trainer(tmp_path, perturbed(params, seed=9))
    t2.restore(tt.save_path)
    assert t2.step == 2 and t2.optimizer.count == 2
    for (n, a), (_, b) in zip(tt.model.state_dict().items(),
                              t2.model.state_dict().items()):
        assert torch.equal(a, b), n
    sa, sb = tt.optimizer.state_dict(), t2.optimizer.state_dict()
    assert sa["count"] == sb["count"]
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    raw = tckpt.load_checkpoint(tt.save_path, "cpu")
    assert set(raw) == {"params", "opt_state", "step"}

    t3 = port_trainer(tmp_path / "r", params, max_step=3)
    calls = []
    real = t3.train_step

    def failing(batch):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return real(batch)

    monkeypatch.setattr(t3, "train_step", failing)
    with pytest.raises(RuntimeError, match="boom"):
        t3.train()
    rescue = tckpt.load_checkpoint(t3.save_path + ".rescue", "cpu")
    assert rescue["step"] == 1 and rescue["opt_state"]["count"] == 1


def test_evaluate_with_coding_on_cpu(jax_side, tmp_path):
    """evaluate with test_coding compresses and decompresses every eval
    batch through the port's FlowCodec (the plain coder on the CPU):
    coding_errors == 0, real_bpd >= test_bpd (container overhead), and no
    rANS kernel was launched.  Tolerance: exact."""
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        cuda_rans,
    )

    _, params = jax_side
    tt = port_trainer(tmp_path, params, test_coding=True, num_streams=64)
    launches = cuda_rans.rans_decode.launches
    ev = tt.evaluate()
    assert ev["coding_errors"] == 0
    assert np.isfinite(ev["real_bpd"]) and ev["real_bpd"] >= ev["test_bpd"]
    assert ev["phase_report"]["decode"]["count"] == 2  # 8 images / batch 4
    assert cuda_rans.rans_decode.launches == launches
    out = tt.sample_images(batch=2, temperatures=(0.5,))
    assert out[0.5].shape == (2, 16, 16, 3)


def test_sample_from_noise_matches_jax(jax_side, tmp_path):
    """IDFlow.sample_from_noise against the JAX model's on the same noise
    arrays: equal on the 1/256 grid except counted rounding ties (<= 0.1%
    of elements, each a grid step off at most one level deep)."""
    jt, params = jax_side
    tt = port_trainer(tmp_path, params)
    rng = np.random.default_rng(12)
    noises = [(0.5 * rng.logistic(0, 1, (3,) + tuple(s))).astype(np.float32)
              for s in tt.model.latent_shapes]
    want = np.asarray(jt.model.apply(params, [jnp.asarray(n) for n in noises],
                                     method=jidflow.IDFlow.sample_from_noise))
    with torch.no_grad():
        got = _np(tt.model.sample_from_noise(
            [torch.from_numpy(n) for n in noises]))
    assert got.shape == (3, 16, 16, 3)
    assert np.all(np.round(got * 256) == got * 256)
    assert np.count_nonzero(got != want) <= 0.001 * got.size


# ---------------------------------------------------------------------------
# config reader and CLI
# ---------------------------------------------------------------------------


def test_yamlite_equals_safe_load_and_overrides_match_jax():
    """The subset reader equals yaml.safe_load on every configs/*.yaml and
    on single scalars; apply_overrides equals the JAX package's on the same
    --set list.  Tolerance: exact."""
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert len(paths) > 20
    for p in paths:
        with open(p) as f:
            assert yamlite.load(p) == yaml.safe_load(f), p
    for s in ("5000", "-3", "0", "1.5", "1e-4", "1.0e-4", ".5", "-.5",
              "true", "False", "yes", "OFF", "null", "~", "", "abc",
              "'q'", '"a b"', "./logs/x.ckpt", "${DATA_ROOT}/x", ".inf",
              "-.Inf", "1_000", "0.75"):
        assert yamlite.parse_scalar(s) == yaml.safe_load(s), s
    sets = ["train.max_step=5000", "train.test_coding=false",
            "train.optimizer.lr=1e-4", "train.new.key=abc",
            "train.save_path='./x.ckpt'", "train.x=1.5", "train.y=",
            "train.z=null"]
    base = yamlite.load(os.path.join(REPO, "configs", "smoke_synthetic.yaml"))
    got = tcli.apply_overrides(json.loads(json.dumps(base)), sets)
    want = jcli.apply_overrides(json.loads(json.dumps(base)), sets)
    assert got == want
    with pytest.raises(SystemExit):
        tcli.apply_overrides(got, ["train.max_step.x=1"])
    with pytest.raises(ValueError):
        yamlite.loads("a: [1, 2]")


def test_cli_main_trains_two_steps_on_cpu(tmp_path):
    """cli.train.main on a shipped config with --device cpu and --set
    overrides trains 2 steps and saves a checkpoint that loads."""
    t = tcli.main([
        "--config", os.path.join(REPO, "configs", "smoke_synthetic.yaml"),
        "--device", "cpu",
        "--set", "train.max_step=2", "--set", "train.step_per_epoch=2",
        "--set", "train.evaluate_interval=2", "--set", "train.save_interval=2",
        "--set", "train.max_eval_batches=1", "--set", "train.num_streams=64",
        "--set", f"train.save_path={tmp_path / 'm.ckpt'}",
        "--set", f"train.writer_path={tmp_path / 'log'}",
    ])
    assert t.step == 2
    assert [s for s, _ in logged(tmp_path / "log", "train loss")] == [1, 2]
    assert logged(tmp_path / "log", "coding errors") == [(2, 0.0)]
    assert tckpt.load_checkpoint(str(tmp_path / "m.ckpt"), "cpu")["step"] == 2
    # --distributed without the torchrun variables raises; it never falls
    # back to one process
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        tcli.main(["--config", "x.yaml", "--distributed"])
    assert not torch.distributed.is_initialized()


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    """Without CUDA, a Trainer, VQVAETrainer, ResidualTrainer,
    TwoLevelTrainer or Finetuner built with no device raises instead of
    training on the CPU, and builds with device="cpu"; a trainer name the
    JAX package does not register either (`FineTuner`) is a KeyError, as
    there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.Trainer(**train_cfg(tmp_path))
    base = train_cfg(tmp_path)
    model = base.pop("model")
    base.pop("test_coding")
    vq = dict(name="VQVAE", channel=3, embed_num=8, embed_dim=4,
              hidden_dims=[4, 4], encoder=dict(block_num=1),
              decoder=dict(block_num=1))
    configs = {
        "VQVAETrainer": dict(base, model=vq),
        "ResidualTrainer": dict(base, flows=model, vqvae={}, nouse_vqvae=True,
                                input_size=[16, 16], patch_batch_size=0),
        "TwoLevelTrainer": dict(base, model=dict(
            name="TwoLevelFlows", H=16, W=16, C=3, pad=[0, 0],
            rough_flows=dict(model, H=8, W=8), fine_flows=dict(model, H=8,
                                                               W=8))),
        "Finetuner": dict(base, model=model, fine_tune=True,
                          fine_tune_lr=1e-3),
    }
    for name, cfg in configs.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.build_trainer({"train": dict(cfg, trainer=name)})
        t = tcli.build_trainer({"train": dict(cfg, trainer=name)},
                               device="cpu")
        assert type(t).__name__ == name and t.device.type == "cpu"
    with pytest.raises(KeyError, match="FineTuner"):
        tcli.build_trainer({"train": {"trainer": "FineTuner"}}, device="cpu")
