"""The PyTorch port's msgpack checkpoint reader, its loading of the JAX
package's checkpoints, and its fine-tuner, held against the JAX package.

Checkpoints are written by the JAX package's own `save_checkpoint` (flax
msgpack) with the states its trainers save, read by the port's pure-Python
reader and by `flax.serialization.msgpack_restore`, and compared leaf by
leaf.  Model weights are flax variables perturbed from numpy seeds (fresh
projections are zero) and batches come from the same seeded loaders in both
packages.  Small size: 16x16x3 images (64x48 through the CLI), nflows 1-2,
growth 8, depth 2.  Everything runs on the CPU (`device="cpu"`).
"""

import copy
import functools
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp
import optax

from finalproject_losslessimagecompression_tpu import models as JM
from finalproject_losslessimagecompression_tpu.train import (
    checkpoint as jckpt,
)
from finalproject_losslessimagecompression_tpu.train import optim as joptim
from finalproject_losslessimagecompression_tpu.train import (
    trainer as jtrainer,
)
from finalproject_losslessimagecompression_tpu.train.finetuner import (
    Finetuner as JFinetuner,
)
from finalproject_losslessimagecompression_tpu_torch import convert
from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch.cli import train as tcli
from finalproject_losslessimagecompression_tpu_torch.train import (
    checkpoint as tckpt,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    trainer as ttrainer,
)
from finalproject_losslessimagecompression_tpu_torch.train.finetuner import (
    Finetuner,
)
from finalproject_losslessimagecompression_tpu_torch.train.msgpack import (
    load_raw,
    msgpack_restore,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3):
# one call over every thread first keeps that out of the comparisons
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_pipelines import small_flow_dict, synth_loader_cfg  # noqa: E402
from test_torch_residual import _np, _perturb, _vq_pair  # noqa: E402
from test_torch_train import (  # noqa: E402
    LR,
    _sign_rule,
    batch_np,
    logged,
    train_cfg,
)
from test_torch_twolevel import _pair as _twolevel_pair  # noqa: E402


@functools.lru_cache(maxsize=None)
def _flow(fuse=True):
    """(model dict, flax IDFlow, perturbed variables) of the small flow of
    `test_torch_train.train_cfg` (16x16, nflows 2, nsplit 2, growth 8,
    depth 2), in either DenseLayer layout; cached per layout (callers do
    not mutate it)."""
    d = copy.deepcopy(train_cfg(pathlib.Path("."))["model"])
    d["couple"]["nn"]["fuse_1x1"] = d["prior"]["nn"]["fuse_1x1"] = fuse
    jm = JM.IDFlow(JM.FlowCfg.from_ref(d))
    var = jax.jit(jm.init)(jax.random.PRNGKey(0),
                           jnp.zeros((1, 16, 16, 3), jnp.float32))
    return d, jm, _perturb(var, 1)


def _same(a, b, path="."):
    """b (the port's reader) equals a (flax's): the same keys in the same
    order, types, dtypes, shapes and bytes; a bfloat16 leaf is a
    torch.bfloat16 tensor with flax's bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) and a.dtype == jnp.bfloat16:
        assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
        assert tuple(b.shape) == a.shape, path
        assert np.array_equal(b.view(torch.int16).numpy().view(np.uint16),
                              a.view(np.uint16)), path
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _both(path):
    with open(path, "rb") as f:
        blob = f.read()
    return flax.serialization.msgpack_restore(blob), load_raw(path)


def _adamax_state(params, clip=1.0, steps=2, seed=0):
    """An optax.chain(clip_by_global_norm, adamax) state after `steps`
    updates with random gradients, as the JAX trainer's optimizer keeps
    it."""
    opt = joptim.build_optimizer(
        dict(name="Adamax", lr=1e-3, grad_clip_norm=clip),
        dict(name="WarmUpScheduler", warmup=2, beta=0.99), 10)
    st = opt.init(params)
    update = jax.jit(opt.update)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1, np.shape(a)).astype(np.float32),
            params)
        _, st = update(g, st, params)
    return jax.device_get(st)


def _flow_state(fuse):
    _, _, var = _flow(fuse)
    return {"params": var, "opt_state": _adamax_state(var), "step": 7}


def _vq_state():
    _, var, _ = _vq_pair(batch_norm=True, seed=3)
    opt = optax.adam(1e-4)
    return {"params": var, "opt_state": jax.device_get(opt.init(var)),
            "step": 2, "counts": np.arange(16, dtype=np.float32)}


def _twolevel_state():
    _, var, _ = _twolevel_pair()
    return {"params": var, "step": 1}


def _misc_state():
    return {"complex": complex(1.5, -2.0), "np_scalar": np.float32(3.25),
            "np_int": np.int64(-9), "none": None, "yes": True, "no": False,
            "bf16": jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4),
                                jnp.bfloat16),
            "ints": [0, -1, 127, 128, -33, 70000, -70000, 2**40, -2**40],
            "floats": [0.5, -1e300], "text": "x" * 300,
            "empty": np.zeros((0, 3), np.int8)}


@pytest.mark.parametrize("case", ["flow_fused", "flow_unfused", "vqvae",
                                  "twolevel", "misc"])
def test_reader_equals_flax(case, tmp_path):
    """Checkpoints written by the JAX package's save_checkpoint -- a flow in
    both DenseLayer layouts with an optax chain(clip, adamax) state and an
    int step, a VQ-VAE with batch_stats and counts, a two-level model, and
    a tree of a complex, numpy scalars, None, bools, a bfloat16 leaf and
    ints of every msgpack width -- read by the port's reader equal
    flax.serialization.msgpack_restore: keys, dtypes, shapes and bytes."""
    state = {"flow_fused": lambda: _flow_state(True),
             "flow_unfused": lambda: _flow_state(False),
             "vqvae": _vq_state, "twolevel": _twolevel_state,
             "misc": _misc_state}[case]()
    path = str(tmp_path / "c.msgpack")
    jckpt.save_checkpoint(path, state)
    want, got = _both(path)
    _same(want, got)
    if case == "misc":
        assert isinstance(got["complex"], complex)
        assert got["bf16"].dtype == torch.bfloat16


def test_reader_joins_chunked_arrays(monkeypatch, tmp_path):
    """Arrays over flax's MAX_CHUNK_SIZE (made small while writing) are
    stored as __msgpack_chunked_array__ dicts; the reader joins them as
    flax does, float32 and bfloat16 alike."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(5)
    state = {"params": {"w": rng.normal(size=(7, 9)).astype(np.float32),
                        "small": np.ones(3, np.float32),
                        "h": jnp.asarray(rng.normal(size=(50,)),
                                         jnp.bfloat16)}, "step": 1}
    blob = flax.serialization.msgpack_serialize(state)
    assert b"__msgpack_chunked_array__" in blob
    path = tmp_path / "c.msgpack"
    path.write_bytes(blob)
    want, got = _both(str(path))
    _same(want, got)
    assert got["params"]["w"].shape == (7, 9)
    assert msgpack_restore(blob)["params"]["h"].shape == (50,)


def test_reader_refuses_malformed_bytes(tmp_path):
    """Truncated documents, trailing bytes and ext types flax never writes
    raise ValueError."""
    path = str(tmp_path / "c.msgpack")
    jckpt.save_checkpoint(path, _misc_state())
    with open(path, "rb") as f:
        blob = f.read()
    for bad in (blob[:-1], blob[: len(blob) // 2], blob + b"\x00",
                b"\xd4\x07\x00", b"\xc1"):
        with pytest.raises(ValueError):
            msgpack_restore(bad)


# ---------------------------------------------------------------------------
# loading JAX checkpoints into the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_jax_checkpoint_model_matches_jax(fuse, tmp_path):
    """A flow checkpoint the JAX package wrote, loaded by the port's
    load_params with params_from_flax: its latents, means and logscales on
    a batch equal the JAX model's (means and logscales within 1e-5
    absolute; latents exactly except counted rounding ties, <= 0.1%)."""
    d, jm, var = _flow(fuse)
    path = str(tmp_path / "flow.msgpack")
    jckpt.save_checkpoint(path, {"params": var, "step": 3})
    tm = TM.IDFlow(TM.FlowCfg.from_ref(d), device="cpu")
    tm.load_state_dict(tckpt.load_params(path, "cpu",
                                         convert.params_from_flax))
    x = batch_np(2)
    jl, jmn, jls = jax.jit(jm.apply)(var, jnp.asarray(x))
    with torch.no_grad():
        tl, tmn, tls = tm(torch.from_numpy(x))
    for a, b in zip(tmn + tls, jmn + jls):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)
    ties = sum(int(np.count_nonzero(_np(a) != np.asarray(b)))
               for a, b in zip(tl, jl))
    assert ties <= 0.001 * sum(a.numel() for a in tl), ties


CLIPPED = dict(name="Adamax", lr=LR, grad_clip_norm=100.0)


def test_jax_trainer_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint as the JAX Trainer saves it after one step of its own
    train step (`trainer.make_train_step`, optimizer chain(clip, adamax)):
    flax msgpack of params, the optax state and the step.  Given to the
    port's Trainer as load_path it resumes there: the step and the update
    count are 1, the params are the file's, and one more port step equals
    the JAX trainer's second step under the sign rule
    (`test_torch_train._sign_rule`).  Before the msgpack reader and the
    dict form in `opt_state_from_optax` this raised ValueError."""
    d, jm, params = _flow(True)
    opt = joptim.build_optimizer(CLIPPED, train_cfg(tmp_path)["scheduler"],
                                 1000)
    step, _ = jtrainer.make_train_step(jm, opt)
    x1, x2 = batch_np(0), batch_np(3)
    p1, s1, _, _ = step(jax.tree_util.tree_map(jnp.array, params),
                        opt.init(params), jnp.asarray(x1))
    p1, s1 = jax.device_get(p1), jax.device_get(s1)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, {"params": p1, "opt_state": s1, "step": 1})
    p2, _, _, _ = step(jax.tree_util.tree_map(jnp.array, p1),
                       jax.tree_util.tree_map(jnp.array, s1),
                       jnp.asarray(x2))
    want = convert.params_from_flax(jax.device_get(p2))

    cfg = train_cfg(tmp_path, optimizer=CLIPPED)
    cfg["model"] = dict(d, load_path=path)
    tt = ttrainer.Trainer(**cfg, device="cpu")
    assert tt.step == 1 and tt.optimizer.count == 1
    before = convert.params_from_flax(p1)
    for name, p in tt.model.named_parameters():
        assert torch.equal(p.detach(), before[name]), name
    tt.train_step(torch.from_numpy(x2))
    assert tt.optimizer.count == 2
    lr = tt.optimizer.schedule(1)
    # the sign rule's gradient: the port's own (it equals JAX's within
    # 1e-3 relative, test_torch_train.test_gradients_match_jax)
    moved = [_sign_rule(_np(p), want[name].numpy(), _np(p.grad),
                        before[name].numpy(), lr)
             for name, p in tt.model.named_parameters()]
    assert max(moved) > 0.5 * lr


def test_opt_state_from_optax_reads_the_dict_form():
    """The optax state as msgpack restores it (nested dicts keyed "0",
    "1", ...; count a 0-d array) converts to the same port state as the
    live NamedTuple state."""
    d, jm, var = _flow(True)
    live = _adamax_state(var, steps=3)
    restored = flax.serialization.msgpack_restore(
        flax.serialization.to_bytes(live))
    assert isinstance(restored, dict)
    names = [n for n, _ in TM.IDFlow(TM.FlowCfg.from_ref(d),
                                     device="cpu").named_parameters()]
    a = convert.opt_state_from_optax(live, names)
    b = convert.opt_state_from_optax(restored, names)
    assert a["count"] == b["count"] == 3
    for i in a["state"]:
        for k in a["state"][i]:
            assert torch.equal(a["state"][i][k], b["state"][i][k]), (i, k)


# ---------------------------------------------------------------------------
# the fine-tuner
# ---------------------------------------------------------------------------

H = W = 16


def _ft_common(tmp_path, **over):
    cfg = dict(
        train_dataloader=synth_loader_cfg((H, W, 3), length=8, train=True),
        test_dataloader=synth_loader_cfg((H, W, 3)),
        optimizer=dict(name="Adamax", lr=1e-2),
        scheduler=dict(name="WarmUpScheduler", warmup=2, beta=0.99),
        max_step=3, step_per_epoch=2, evaluate_interval=3,
        save_interval=1000, save_path=str(tmp_path / "ft.ckpt"),
        writer_path=str(tmp_path / "logs"))
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def ft_weights(tmp_path_factory):
    """(model dict with load_path, the JAX checkpoint's path): a small
    flow's perturbed weights as a JAX msgpack checkpoint."""
    d, _, var = _flow(True)
    path = str(tmp_path_factory.mktemp("ft") / "flow.msgpack")
    jckpt.save_checkpoint(path, {"params": var, "step": 0})
    return dict(d, load_path=path), path


def _tuner_close(got, want, lr, steps):
    """Tuners after `steps` Adam-type updates: elements agree within
    1e-3 * lr, except where a near-zero gradient's sign differs between
    the backends (Adam normalises it to +-lr): those are counted, <= 2% of
    the elements, and still within 2 * steps * lr."""
    d = np.abs(got - want)
    assert np.all(d <= 2 * steps * lr + 1e-6), float(d.max())
    off = int(np.count_nonzero(d > 1e-3 * lr))
    assert off <= 0.02 * d.size, (off, d.size)
    return off


@pytest.mark.parametrize("fine_tune_lr", [1e-2, None],
                         ids=["adam_lr", "config_adamax_warmup"])
def test_finetuner_matches_jax(fine_tune_lr, ft_weights, tmp_path):
    """The JAX Finetuner and the port's, the same weights (the port reads
    the JAX checkpoint) and batches, 3 tuning steps: per-step bpd within
    1e-4 relative, the tuner by `_tuner_close`; with fine_tune_lr Adam at
    that rate, without it the config's Adamax with WarmUp."""
    model, _ = ft_weights
    jf = JFinetuner(model=model, fine_tune=True, fine_tune_lr=fine_tune_lr,
                    **_ft_common(tmp_path / "j"))
    jf.train()
    tf = Finetuner(model=model, fine_tune=True, fine_tune_lr=fine_tune_lr,
                   **_ft_common(tmp_path / "t"), device="cpu")
    frozen = {k: v.clone() for k, v in tf.model.state_dict().items()}
    tf.train()
    for k, v in tf.model.state_dict().items():
        assert torch.equal(v, frozen[k]), k  # the model stays frozen
    jb = logged(tmp_path / "j" / "logs", "bpd")
    tb = logged(tmp_path / "t" / "logs", "bpd")
    assert [s for s, _ in tb] == [s for s, _ in jb] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in tb], [v for _, v in jb],
                               rtol=1e-4)
    assert logged(tmp_path / "t" / "logs", "bpd mean")[0][0] == 3
    lr = fine_tune_lr or max(tf.tuner_opt.schedule(c) for c in range(3))
    _tuner_close(_np(tf.tuner), np.asarray(jf.tuner), lr, 3)
    assert float(tf.tuner.detach().abs().max()) > 0


def test_finetuner_resume_and_measure_only(ft_weights, tmp_path):
    """A tuning run saves {tuner, tuner_state, step} every save_interval
    and at the end; resume=True restores tuner, Adam state and step
    exactly and trains on.  With fine_tune off the tuner stays zero, bpd
    is logged every step and no checkpoint is written."""
    model, _ = ft_weights
    common = _ft_common(tmp_path, save_interval=2)
    f = Finetuner(model=model, fine_tune=True, fine_tune_lr=1e-3, **common,
                  device="cpu")
    f.train()
    assert set(tckpt.load_checkpoint(f.save_path, "cpu")) == {
        "tuner", "tuner_state", "step"}
    f2 = Finetuner(model=model, fine_tune=True, fine_tune_lr=1e-3,
                   resume=True, **common, device="cpu")
    assert f2.step == 3 and torch.equal(f2.tuner, f.tuner)
    a, b = f.tuner_opt.state_dict(), f2.tuner_opt.state_dict()
    assert a["count"] == b["count"] == 3
    assert all(torch.equal(a["state"][0][k], b["state"][0][k])
               for k in a["state"][0])
    f2.max_step = 4
    f2.train()
    assert f2.step == 4

    m = tmp_path / "measure"
    f3 = Finetuner(model=model, fine_tune=False, device="cpu",
                   **_ft_common(m, save_interval=1))
    f3.train()
    assert float(f3.tuner.detach().abs().max()) == 0.0
    assert not os.path.exists(f3.save_path)
    assert [s for s, _ in logged(m / "logs", "bpd")] == [1, 2, 3]


def test_cli_train_runs_config_trans_test(ft_weights, tmp_path):
    """configs/config-trans-test.yaml through the port's cli.train, narrowed
    by --set, its CelebA paths replaced by a folder of 215x178 PNGs made
    here: the model at load_path is once a port checkpoint and once the
    JAX msgpack checkpoint of the same weights, and both runs log the same
    bpd and save the same tuner."""
    from PIL import Image

    rng = np.random.default_rng(30)
    pngs = tmp_path / "celeba"
    pngs.mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (215, 178, 3), dtype=np.uint8)
                        ).save(pngs / f"{i}.png")
    flow = small_flow_dict(64, 48, nsplit=3, nflows=1, scale=2)
    jm = JM.IDFlow(JM.FlowCfg.from_ref(flow))
    var = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 48, 3))), 31)
    jpath = str(tmp_path / "flow.msgpack")
    jckpt.save_checkpoint(jpath, {"params": var, "step": 0})
    tpath = str(tmp_path / "flow.ckpt")
    tckpt.save_checkpoint(tpath, {"params": convert.params_from_flax(var)})
    narrow = ["train.model.nflows=1"] + [
        f"train.model.{p}.nn.{k}" for p in ("couple", "prior")
        for k in ("growth_channel=8", "depth=2")]
    out = {}
    for name, ckpt in (("port", tpath), ("jax", jpath)):
        d = tmp_path / name
        sets = narrow + [
            f"train.model.load_path={ckpt}", "train.max_step=2",
            "train.evaluate_interval=2", "train.save_interval=2",
            f"train.save_path={d / 'ft.ckpt'}",
            f"train.writer_path={d / 'log'}"]
        for split in ("train_dataloader", "test_dataloader"):
            sets += [f"train.{split}.path={pngs}",
                     f"train.{split}.batch_size=1"]
        t = tcli.main(["--config", os.path.join(REPO, "configs",
                                                "config-trans-test.yaml"),
                       "--device", "cpu"]
                      + [a for s in sets for a in ("--set", s)])
        assert type(t).__name__ == "Finetuner" and t.step == 2
        assert t.cfg.H == 64 and t.cfg.W == 48 and t.fine_tune
        out[name] = ([v for _, v in logged(d / "log", "bpd")],
                     tckpt.load_checkpoint(str(d / "ft.ckpt"), "cpu"))
    assert out["port"][0] == out["jax"][0] and len(out["port"][0]) == 2
    assert torch.equal(out["port"][1]["tuner"], out["jax"][1]["tuner"])
    assert out["port"][1]["step"] == 2
