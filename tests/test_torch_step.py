"""The port's single-dispatch train steps held against the JAX package's.

`make_train_step`, `make_multi_train_step` and `make_forward` (the JAX
trainer's jitted programs; on the card the port captures them as CUDA
graphs, here on the CPU they run their eager bodies) against the JAX
functions on the same perturbed flax weights and seeded batches: three
steps of Adamax with a global-norm clip and the warm-up schedule at
`step_per_epoch=1`, so the learning rate changes at every step.  Then the
block learning-rate tensor against JAX's schedule, optimizer states moving
between the host and the device counter forms, and every trainer's steps
built through `utils.graphs` (graphs off on the CPU) with bodies that read
nothing back to the host.  Small size: 16x16x3 images, nflows 2, nsplit 2,
DenseBlocks of growth 8 and depth 2, batch 4.  No process is spawned.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from finalproject_losslessimagecompression_tpu import models as JM
from finalproject_losslessimagecompression_tpu.train import optim as joptim
from finalproject_losslessimagecompression_tpu.train import trainer as jtrainer
from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch.convert import (
    params_from_flax,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    checkpoint as tckpt,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    finetuner as tfinetuner,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    optim as toptim,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    residual_trainer as tresidual,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    trainer as ttrainer,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    twolevel_trainer as ttwolevel,
)
from finalproject_losslessimagecompression_tpu_torch.train import (
    vqvae_trainer as tvqvae,
)
from finalproject_losslessimagecompression_tpu_torch.utils.graphs import (
    GraphedStep,
)
from test_torch_graphs import stub_graphs

torch.set_num_threads(2)  # the suite runs several workers at once
# a process's first parallel CPU exp can be inaccurate (test_torch_flow.py)
torch.exp(torch.zeros(1 << 16))

LR, CLIP, STEPS, BATCH = 1e-3, 0.45, 3, 4
OPT = dict(name="Adamax", lr=LR, grad_clip_norm=CLIP)
SCHED = dict(name="WarmUpScheduler", warmup=2, beta=0.9)


def _nn():
    return dict(name="DenseBlock", growth_channel=8, depth=2,
                layer=dict(name="DenseLayer", act="ReLU"))


def _flow_dict(H=16, W=16, nsplit=2, name="IDFlows", **extra):
    rnd = dict(name="Round", nbits=8)
    return dict(name=name, nflows=2, nbits=8, nsplit=nsplit, H=H, W=W, C=3,
                couple=dict(name="AdditiveCouple", split=0.75, nn=_nn(),
                            round=rnd),
                extenddim=dict(name="ExtendDim", scale=2),
                prior=dict(name="Prior", round=rnd, nn=_nn()),
                distribution=dict(name="DLogistic"), round=rnd, **extra)


FLOWS = {"plain": _flow_dict(),
         "conditional": _flow_dict(name="ConditionalFlows",
                                   conv_for_cond=True)}


def _grid(seed, shape):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(0, 1, shape) * 256) / 256).astype(
        np.float32)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module", params=sorted(FLOWS))
def pair(request):
    """(kind, flax params, batches [STEPS, B, 16, 16, 3], conds or None,
    JAX's results): three steps of JAX's make_train_step (losses, final
    params), for the plain flow its make_multi_train_step over the same
    block (losses, final params), and its make_forward on the first batch
    at the initial params."""
    kind = request.param
    conditional = kind == "conditional"
    jm = JM.IDFlow(JM.FlowCfg.from_ref(FLOWS[kind]))
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    # seeded weights in flax's layout (no compiled init): lecun-normal
    # kernels, biases off zero, so no projection is trivially zero
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *((x, x) if conditional else (x,)))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(0.0, 1.0, a.shape) / np.sqrt(
            np.prod(a.shape[:-1])) if a.ndim > 1 else rng.normal(
                0.0, 0.05, a.shape)).astype(np.float32), shapes)
    batches = _grid(1, (STEPS, BATCH, 16, 16, 3))
    conds = _grid(2, (STEPS, BATCH, 16, 16, 3)) if conditional else None

    def cond(j):
        return None if conds is None else jnp.asarray(conds[j])

    opt = joptim.build_optimizer(OPT, SCHED, step_per_epoch=1)
    step, _ = jtrainer.make_train_step(jm, opt, conditional=conditional)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    st, losses = opt.init(p), []
    for j in range(STEPS):
        p, st, loss, _ = step(p, st, jnp.asarray(batches[j]), cond(j))
        losses.append(float(loss))
    want = {"losses": np.array(losses),
            "params": params_from_flax(jax.device_get(p)),
            "forward": jax.device_get(jtrainer.make_forward(
                jm, conditional=conditional)(
                    params, jnp.asarray(batches[0]), cond(0)))}
    if not conditional:
        multi = jtrainer.make_multi_train_step(jm, opt, STEPS)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        p, _, ml = multi(p, opt.init(p), jnp.asarray(batches))
        want["multi_losses"] = np.asarray(ml)
        want["multi_params"] = params_from_flax(jax.device_get(p))
    return kind, params, batches, conds, want


def _port(kind, params):
    """The port's flow with the flax params, and its optimizer."""
    tm = TM.IDFlow(TM.FlowCfg.from_ref(FLOWS[kind]), device="cpu", seed=0)
    tm.load_state_dict(params_from_flax(params))
    return tm, toptim.build_optimizer(tm.parameters(), OPT, SCHED,
                                      step_per_epoch=1)


def _cond(conds, j):
    return None if conds is None else torch.from_numpy(conds[j])


def _port_steps(kind, params, batches, conds):
    """Three of the port's make_train_step calls: (model, optimizer,
    losses, auxes, each step's gradients as the update saw them, clipped
    or not, and whether the clip fired)."""
    tm, opt = _port(kind, params)
    step, _ = ttrainer.make_train_step(tm, opt,
                                       conditional=conds is not None)
    assert isinstance(step, GraphedStep) and not step.graphs
    losses, auxes, grads, clipped = [], [], [], []
    for j in range(STEPS):
        loss, aux = step(torch.from_numpy(batches[j]), _cond(conds, j))
        assert opt.count == j + 1
        losses.append(float(loss))
        auxes.append(aux)
        g = {k: v.grad.clone() for k, v in tm.named_parameters()}
        grads.append(g)
        norm = float(torch.sqrt(sum((v * v).sum() for v in g.values())))
        clipped.append(abs(norm - CLIP) < 1e-5 * CLIP)
    return tm, opt, np.array(losses), auxes, grads, clipped


def _close_params(got, want, grads):
    """Parameters within 1e-6, except where a step's gradient is near
    zero, on at most 1% of the elements (counted as
    tests/test_torch_parallel.py counts them, over three steps): Adamax
    divides each gradient by its own running magnitude, which turns the
    two backends' gradient differences (up to 5.5e-7 absolute, ROADMAP
    section 3) into up to 2 lr a step where |g| is small; three steps of
    that reach elements with |g| up to ~1e-3 of the step's largest (the
    one-step test of tests/test_torch_parallel.py uses 1e-4)."""
    lr_sum = sum(toptim.warmup_exp_schedule(LR, 2, 0.9, 1)(j)
                 for j in range(STEPS))
    off = total = 0
    for k, v in want.items():
        diff = np.abs(_np(got[k]) - v.numpy())
        near = np.zeros(diff.shape, bool)
        for g in grads:
            gmax = max(float(t.abs().max()) for t in g.values())
            near |= np.abs(_np(g[k])) <= 1e-3 * gmax
        assert not np.any((diff > 1e-6) & ~near), k
        assert np.all(diff <= 2 * lr_sum + 1e-6), k
        off += int(np.sum(diff > 1e-6))
        total += diff.size
    assert off <= 0.01 * total, (off, total)


def test_train_step_matches_jax(pair):
    """make_train_step, three steps (plain and conditional=True) against
    JAX's: losses within 1e-5 relative, parameters as `_close_params`
    (near-zero gradients taken from the port's, which agree with JAX's
    within ~1e-8); the update count and each step's learning rate follow
    the schedule, and the global-norm clip fires at one step at least.
    The step's eval_step gives JAX's first loss (its loss at the initial
    parameters) within 1e-5 relative."""
    kind, params, batches, conds, want = pair
    tm, opt = _port(kind, params)
    _, eval_step = ttrainer.make_train_step(tm, opt,
                                            conditional=conds is not None)
    np.testing.assert_allclose(
        float(eval_step(torch.from_numpy(batches[0]), _cond(conds, 0))[0]),
        want["losses"][0], rtol=1e-5)
    tm, opt, losses, auxes, grads, clipped = _port_steps(kind, params,
                                                         batches, conds)
    assert any(clipped), clipped
    assert float(opt.lrs(1)[0]) == toptim.warmup_exp_schedule(
        LR, 2, 0.9, 1)(STEPS - 1)
    assert all(set(a) == {"per_split_bpd", "max_z", "min_z"} for a in auxes)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    _close_params(dict(tm.named_parameters()), want["params"], grads)


def test_multi_train_step_matches_jax_and_single_steps(pair):
    """make_multi_train_step with length 3 on a [3, B, H, W, C] block
    (conds [3, B, H, W, C] for conditional=True) against JAX's three steps
    (JAX's scanned multi-step for the plain flow; its make_train_step,
    three times, for the conditional one, whose scan takes no cond):
    losses within 1e-5 relative, parameters as `_close_params`; and bit
    for bit equal to three of the port's single steps, optimizer state
    included."""
    kind, params, batches, conds, want = pair
    tm, topt = _port(kind, params)
    multi = ttrainer.make_multi_train_step(tm, topt, STEPS,
                                           conditional=conds is not None)
    assert isinstance(multi, GraphedStep) and not multi.graphs
    losses = multi(torch.from_numpy(batches),
                   None if conds is None else torch.from_numpy(conds))
    assert losses.shape == (STEPS,) and topt.count == STEPS
    single, sopt, one, _, grads, _ = _port_steps(kind, params, batches,
                                                 conds)
    key = "multi_" if conds is None else ""
    np.testing.assert_allclose(_np(losses), want[key + "losses"], rtol=1e-5)
    _close_params(dict(tm.named_parameters()), want[key + "params"], grads)
    assert np.array_equal(_np(losses), one.astype(np.float32))
    for (k, a), b in zip(tm.state_dict().items(),
                         single.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = topt.state_dict(), sopt.state_dict()
    assert sa["count"] == sb["count"] == STEPS
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)


def test_forward_matches_jax(pair):
    """make_forward against JAX's: latents equal except rounding ties (at
    most 0.1% of the elements, one grid step each), means and logscales
    within 1e-5 absolute."""
    kind, params, batches, conds, want = pair
    tm, _ = _port(kind, params)
    got = ttrainer.make_forward(tm, conditional=conds is not None)(
        torch.from_numpy(batches[0]), _cond(conds, 0))
    for g, w in zip(got[0], want["forward"][0]):
        g, w = _np(g), np.asarray(w)
        ties = np.count_nonzero(g != w)
        assert ties <= 0.001 * g.size, ties
        assert np.abs(g - w).max() <= 1 / 256 + 1e-7
    for part in (1, 2):
        for g, w in zip(got[part], want["forward"][part]):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                       atol=1e-5)


def test_block_lrs_equal_jax_schedule():
    """The [K] learning-rate tensor a step of K updates reads holds the
    schedule at count .. count+K-1: bit for bit the port's host schedule
    (what an eager step sets), and JAX's warmup_exp_schedule as its train
    step evaluates it (in the compiled program) within 2 float32 ulps
    (XLA's pow is its own approximation; ROADMAP section 3), at counts
    across the warm-up and the decay.  It is the same tensor at every
    call."""
    tp = [torch.nn.Parameter(torch.zeros(3))]
    counts = np.array([0, 1, 5, 999, 2999, 123_457], dtype=np.int32)
    for args in ((1e-3, 10, 0.99, 1000), (0.5, 2, 0.9, 3), (1e-2, 2, 0.9, 1)):
        base, warmup, beta, spe = args
        opt = toptim.build_optimizer(
            tp, dict(name="Adamax", lr=base),
            dict(name="WarmUpScheduler", warmup=warmup, beta=beta), spe)
        mine = toptim.warmup_exp_schedule(*args)
        jit = jax.jit(jax.vmap(joptim.warmup_exp_schedule(*args)))
        for K in (1, 4):
            first = opt.next_lrs(K)
            want = np.asarray(jit(jnp.asarray(
                (counts[:, None] + np.arange(K)).ravel())))
            for i, count in enumerate(counts):
                opt.count = int(count)
                lrs = opt.next_lrs(K)
                assert lrs is first and lrs.dtype == torch.float32
                got = lrs.numpy()
                assert np.array_equal(got, np.array(
                    [mine(int(count) + j) for j in range(K)], np.float32))
                ulps = np.abs(got.view(np.int32).astype(np.int64)
                              - want[i * K:(i + 1) * K].view(np.int32))
                assert np.all(ulps <= 2), (args, count, ulps)


@pytest.fixture
def capturable_on_cpu(monkeypatch):
    """Let torch's capturable Adam / Adamax run on CPU tensors: their
    device-counter algebra, with a tensor learning rate, as on the card."""
    for name in ("adam", "adamax"):
        mod = importlib.import_module(f"torch.optim.{name}")
        monkeypatch.setattr(mod, "_get_capturable_supported_devices",
                            lambda supports_xla=True: ["cpu", "cuda"])


@pytest.mark.parametrize("name", ["Adamax", "Adam"])
def test_counter_forms_resume_in_each_other(capturable_on_cpu, name,
                                            tmp_path):
    """An optimizer state written by a capturable optimizer (the card's
    form: step counters float32 on the parameters' device) resumes in a
    host-counter one (the CPU's, and the form the port's trainers wrote
    before their steps were captured), and the reverse: equal moments,
    counters and count, the counters where the loading optimizer keeps
    them; one more update from the resumed states agrees within 1e-6
    relative to the tensor's largest value (the two algebras round
    differently, as tests/test_torch_train.py's optimizer test allows)."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(0, 1, (5, 4)).astype(np.float32)
    gs = [rng.normal(0, 1, (5, 4)).astype(np.float32) for _ in range(3)]

    def build(capturable):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        return p, toptim.build_optimizer(
            [p], dict(name=name, lr=0.1, grad_clip_norm=2.0), SCHED, 1,
            capturable=capturable)

    for src_cap in (True, False):
        p, opt = build(src_cap)
        for g in gs[:2]:
            p.grad = torch.from_numpy(g.copy())
            opt.step()
        path = tmp_path / f"opt_{src_cap}.ckpt"
        tckpt.save_checkpoint(str(path), {"opt_state": opt.state_dict()})
        sd = tckpt.load_checkpoint(str(path), "cpu")["opt_state"]
        q, other = build(not src_cap)
        with torch.no_grad():
            q.copy_(p)
        other.load_state_dict(sd)
        so = other.state_dict()
        assert so["count"] == sd["count"] == 2
        for k, v in opt.state_dict()["state"][0].items():
            assert torch.equal(so["state"][0][k].float(), v.float()), k
        assert so["state"][0]["step"].dtype == torch.float32
        for o, t in ((opt, p), (other, q)):
            t.grad = torch.from_numpy(gs[2].copy())
            o.step()
        np.testing.assert_allclose(_np(q), _np(p), rtol=1e-6,
                                   atol=1e-6 * float(p.detach().abs().max()))
        assert other.count == opt.count == 3


# ---------------------------------------------------------------------------
# every trainer's steps go through utils.graphs
# ---------------------------------------------------------------------------

VQ_DICT = dict(
    name="VQVAE", channel=3, embed_num=16, embed_dim=8, hidden_dims=[8, 16],
    encoder=dict(name="VQEncoder", block_num=1,
                 block=dict(name="ResBlock", batch_norm=True)),
    decoder=dict(name="VQDecoder", block_num=1,
                 block=dict(name="ResBlock", batch_norm=True)),
    distribution=dict(name="BinomialDistribution"),
    vectorquantizer=dict(reinit_interval=0.5, threshold=0.1),
)


def _data(size=16, train=True):
    return dict(name="CustomDataLoader", batch_size=BATCH, nbits=8,
                train=train, shuffle=train,
                dataset=dict(name="SyntheticImages", size=[size, size, 3],
                             length=8, seed=1))


def _common(tmp, size=16, **over):
    cfg = dict(train_dataloader=_data(size),
               test_dataloader=_data(size, train=False), optimizer=OPT,
               scheduler=SCHED, max_step=2, step_per_epoch=1,
               evaluate_interval=1000, save_interval=1000,
               save_path=str(tmp / "m.ckpt"), writer_path=str(tmp / "log"))
    cfg.update(over)
    return cfg


def _vq_checkpoint(tmp):
    """A checkpoint of a seeded VQ-VAE (the residual trainer's frozen
    one)."""
    vq = TM.build_vqvae_from_ref(dict(VQ_DICT), device="cpu", seed=0)
    path = str(tmp / "vq.ckpt")
    tckpt.save_checkpoint(path, {"params": vq.state_dict()})
    return path


def _build(kind, tmp):
    """(trainer, its GraphedSteps, one step through its public path,
    updates per step)."""
    if kind in ("flow", "flow_k2"):
        K = 2 if kind == "flow_k2" else 1
        t = ttrainer.Trainer(model=FLOWS["plain"], steps_per_dispatch=K,
                             **_common(tmp, step_per_epoch=K),
                             device="cpu")
        steps = [t.train_step] + ([t.train_multi] if K > 1 else [])
        return t, steps, lambda: t.train_block(t.next_block(K)), K
    if kind == "vqvae":
        t = tvqvae.VQVAETrainer(model=dict(VQ_DICT), **_common(tmp),
                                device="cpu")
        return (t, [t.train_step, t.update_step],
                lambda: t.update(np.asarray(next(t.trainloader))), 1)
    if kind == "residual":
        t = tresidual.ResidualTrainer(
            flows=_flow_dict(8, 8, name="ConditionalFlows",
                             conv_for_cond=True),
            vqvae={**VQ_DICT, "checkpoint": _vq_checkpoint(tmp)},
            input_size=[16, 16], patch_batch_size=6, **_common(tmp),
            device="cpu")
        return (t, [t.train_step], lambda: t.train_step(torch.from_numpy(
            np.asarray(next(t.trainloader)))), 1)
    if kind == "twolevel":
        tl = dict(name="TwoLevelFlows", H=15, W=15, C=3, pad=[1, 1],
                  rough_flows=_flow_dict(4, 4, nsplit=1),
                  fine_flows=_flow_dict(8, 8, nsplit=1))
        t = ttwolevel.TwoLevelTrainer(model=tl, **_common(tmp, size=15),
                                      device="cpu")
        return (t, [t.train_step], lambda: t.train_step(torch.from_numpy(
            np.asarray(next(t.trainloader)))), 1)
    t = tfinetuner.Finetuner(model=FLOWS["plain"], fine_tune=True,
                             **_common(tmp), device="cpu")
    return (t, [t.tune_step], lambda: t.tune_step(torch.from_numpy(
        np.asarray(next(t.trainloader)))), 1)


TRAINERS = ["flow", "flow_k2", "vqvae", "residual", "twolevel", "finetune"]
# ops that read a device value back to the host: a captured step may run
# none of them
HOST_READS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero",
              "bincount", "unique", "_unique", "_unique2", "unique_dim",
              "unique_consecutive", "masked_select", "repeat_interleave",
              "argwhere"}


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.__name__.split(".")[0])
        if func.__name__.startswith("index.") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            self.names.add("index_with_mask")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", TRAINERS)
def test_trainer_steps_go_through_graphs(kind, tmp_path, monkeypatch,
                                         capturable_on_cpu):
    """Each trainer builds its steps through utils.graphs and, on the CPU,
    reports graphs false: its steps run their eager bodies, capture
    nothing, and a step through the trainer's public path advances the
    update count by its updates.  With the card's capturable optimizer
    algebra (run on the CPU), the step reads nothing back to the host: no
    op of HOST_READS and no boolean-mask index runs in it."""
    for mod in (ttrainer, tvqvae, tresidual, ttwolevel, tfinetuner):
        monkeypatch.setattr(mod, "build_optimizer", functools.partial(
            toptim.build_optimizer, capturable=True))
    t, steps, one_step, updates = _build(kind, tmp_path)
    assert t.graphs is False
    assert all(isinstance(s, GraphedStep) and not s.graphs for s in steps)
    opt = t.tuner_opt if kind == "finetune" else t.optimizer
    assert opt.capturable
    ops = _Ops()
    with ops:
        one_step()
    assert opt.count == updates
    assert not ops.names & (HOST_READS | {"index_with_mask"}), \
        ops.names & (HOST_READS | {"index_with_mask"})
    assert all(s.captures == 0 and s.replays == 0 for s in steps)


# ---------------------------------------------------------------------------
# the graphed call sequence, with stub graphs on the CPU
# ---------------------------------------------------------------------------


def _state(t, opt):
    out = dict(t.model.state_dict())
    sd = opt.state_dict()
    out.update({f"opt.{i}.{k}": v for i, st in sd["state"].items()
                for k, v in st.items()})
    for name in ("counts", "replaced", "tuner"):
        if hasattr(t, name):
            out[name] = getattr(t, name).detach()
    if hasattr(t, "gen"):
        out["gen"] = t.gen.get_state()
    return out


@pytest.mark.parametrize("kind", TRAINERS)
def test_graphed_call_sequence_equals_eager(kind, tmp_path):
    """The card's call sequence of each trainer's step (the first call
    eager, the second capturing, then replays), run on the CPU with stub
    graphs whose replay re-runs the body over the static inputs: four
    calls through the trainer's public path equal four calls of a twin's
    step.eager bit for bit (parameters, buffers, optimizer state, VQ
    counts, tuner, the patch draw's generator), with one capture and three
    replays, the update count advanced per call, and a learning rate that
    changes at every call (an epoch per call) read from the static
    tensor."""
    calls = 4
    a, steps, one_step, updates = _build(kind, tmp_path / "a")
    b, twin_steps, _, _ = _build(kind, tmp_path / "b")
    for s_ in steps:
        stub_graphs(s_.cache)
    opt_a = a.tuner_opt if kind == "finetune" else a.optimizer
    opt_b = b.tuner_opt if kind == "finetune" else b.optimizer
    seen = []
    for _ in range(calls):
        one_step()
        seen.append(opt_a.lrs(updates).tolist())
    step = steps[-1] if kind != "flow_k2" else steps[1]
    assert (step.captures, step.replays) == (1, calls - 1)
    assert len({tuple(v) for v in seen}) == calls
    assert opt_a.count == calls * updates
    eager = twin_steps[-1] if kind != "flow_k2" else twin_steps[1]
    for _ in range(calls):
        if kind in ("flow", "flow_k2"):
            block = b.next_block(updates)
            eager.eager(block if updates > 1 else block[0])
        else:
            eager.eager(torch.from_numpy(np.asarray(next(b.trainloader))))
    assert opt_b.count == calls * updates
    sa, sb = _state(a, opt_a), _state(b, opt_b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
