"""The port's multi-chip dry run (`demo/multichip.py`, the counterpart of
`__graft_entry__.py`) on 4 gloo ranks on the CPU, mesh (2, 2): the first
test of `tile` sub-groups, held against the JAX package's pieces on 4 of
the 8 virtual CPU devices.

One group of 4 ranks is spawned for the module (`spawn_ranks`, a 60 s
group timeout).  Each rank runs `multichip.run_rank` at the parity size
(JAX's dry-run shapes and inputs) with the JAX package's weights: the
models' parameter trees (their shapes from `jax.eval_shape` of `init`)
drawn in numpy from seeds and carried over by `convert`.  The ranks save
their reports and trained parameters; the JAX side runs in this process
while they work.  JAX's whole `dryrun_multichip` takes minutes on this
CPU (its fused codecs compile), so the codecs are held to their own
exactness, to a single-process encode of each shard and to the JAX
classes' container plans, and JAX's raw sharded rANS codes the same
symbols.  The rank processes import no JAX.
"""

import json
import os
import sys
import threading
from dataclasses import replace

import numpy as np
import pytest
import torch

from finalproject_losslessimagecompression_tpu_torch.cli import scaling
from finalproject_losslessimagecompression_tpu_torch.codec import (
    interleaved as IL,
)
from finalproject_losslessimagecompression_tpu_torch.demo import (
    multichip as MC,
)
from finalproject_losslessimagecompression_tpu_torch.parallel.multiproc import (  # noqa: E501
    spawn_ranks,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3)
torch.exp(torch.zeros(1 << 16))

D = 4
STEPS = 1  # JAX's dry run takes one step
LR = 1e-3


def _drawn(shapes, seed: int, sd: float = 0.05):
    """A parameter tree of the shapes of `shapes`, every leaf drawn from
    N(0, sd^2) by numpy's generator of `seed`."""
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, sd, a.shape).astype(np.float32), shapes)


def _jax_models():
    """JAX's dry-run models (`__graft_entry__.py:103-108`): (conditional
    flow, unconditional flow, VQ-VAE, their cfg)."""
    from finalproject_losslessimagecompression_tpu import models as JM
    from finalproject_losslessimagecompression_tpu.models.vqvae import VQVAE

    nn = JM.DenseBlockCfg(16, 2, "LeakyReLU")
    cfg = JM.FlowCfg(H=8, W=8, C=3, nflows=2, nsplit=2,
                     couple=JM.CouplingCfg(0.75, nn), prior_nn=nn,
                     conditional=True)
    vq = VQVAE(channel=3, embed_num=64, embed_dim=8, hidden_dims=(8, 16),
               block_num=1)
    return JM.IDFlow(cfg), JM.IDFlow(replace(cfg, conditional=False)), vq, \
        cfg


def _jax_variables():
    import jax
    import jax.numpy as jnp

    flow, uflow, vq, _ = _jax_models()
    key = jax.random.PRNGKey(0)
    px0 = jnp.zeros((4, 8, 8, 3), jnp.float32)
    return {
        "flow": _drawn(jax.eval_shape(flow.init, key, px0, px0), 1),
        "uflow": _drawn(jax.eval_shape(uflow.init, key, px0[:1]), 2),
        "vq": _drawn(jax.eval_shape(vq.init, key,
                                    jnp.zeros((1, 16, 16, 3))), 3),
    }


def _rank(tmp):
    """One rank: the dry run with the JAX package's weights; saves its
    report, its trained flow and whether it imported JAX."""
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    built = {}

    def build(device):
        flow, uflow, vq, size = MC.parity_models(device)
        for model, key in ((flow, "flow"), (uflow, "uflow"), (vq, "vq")):
            model.load_state_dict(inp[key])
        built["flow"] = flow
        return flow, uflow, vq, size

    args = MC._parser().parse_args(
        ["--device", "cpu", "--timeout", "60", "--steps", str(STEPS),
         "--out", os.path.join(tmp, "multichip.json")])
    report = MC.run_rank(args, build)
    torch.save({"report": report,
                "flow": {k: v.clone() for k, v in
                         built["flow"].state_dict().items()},
                "jax_loaded": sorted(
                    m for m in sys.modules if m.split(".")[0] in (
                        "jax", "jaxlib", "flax",
                        "finalproject_losslessimagecompression_tpu"))},
               os.path.join(tmp, f"rank{report['rank']}.pt"))


def _jax_side(var):
    """JAX's pieces on the parity inputs over a (2, 2) mesh of 4 devices:
    the step's losses, params and per-step gradients; the VQ indices; the
    raw sharded rANS containers and their decode."""
    import jax
    import jax.numpy as jnp
    import optax

    from finalproject_losslessimagecompression_tpu.models.idflow import (
        log_likelihood,
    )
    from finalproject_losslessimagecompression_tpu.models.vqvae import VQVAE
    from finalproject_losslessimagecompression_tpu.ops.reshape import (
        patch_split,
    )
    from finalproject_losslessimagecompression_tpu.ops.rounding import (
        round_to_grid,
    )
    from finalproject_losslessimagecompression_tpu.parallel import (
        make_mesh,
        replicate,
        shard_batch,
        sharded_decode,
        sharded_encode,
        sharded_vq_lookup,
    )

    flow, _, vq, cfg = _jax_models()
    mesh = make_mesh((2, 2), devices=jax.devices()[:D])
    rng = np.random.default_rng(0)
    data = jnp.asarray(MC.grid(rng, (2 * D, 16, 16, 3)))
    opt = optax.adamax(LR)

    def loss_fn(fp, patches, rec_patches):
        latents, means, logscales = flow.apply(fp, patches, rec_patches)
        lp, _ = log_likelihood(cfg, latents, means, logscales)
        return -jnp.mean(lp)

    def full_step(fp, op, vp, batch):  # __graft_entry__.py:124-134
        rec = vq.apply(vp, (batch - 0.5) / 0.5, method=VQVAE.reconstruct)
        rec = round_to_grid(rec * 0.5 + 0.5, cfg.nbits)
        patches = patch_split(batch - rec, cfg.H, cfg.W)
        rec_patches = patch_split(rec, cfg.H, cfg.W)
        loss, grads = jax.value_and_grad(loss_fn)(fp, patches, rec_patches)
        updates, op = opt.update(grads, op, fp)
        return optax.apply_updates(fp, updates), op, loss, grads

    repl = replicate(mesh)
    step = jax.jit(full_step,
                   in_shardings=(repl, repl, repl, shard_batch(mesh)),
                   out_shardings=(repl, repl, repl, repl))
    fp, vp = var["flow"], var["vq"]
    op = opt.init(fp)
    losses, grads = [], []
    with mesh:
        for _ in range(STEPS):
            fp, op, loss, g = step(fp, op, vp, data)
            losses.append(float(loss))
            grads.append(jax.device_get(g))
    x = rng.normal(0, 1, (16, 8)).astype(np.float32)
    cb = vp["params"]["vq"]["codebook"]
    _, idx = sharded_vq_lookup(jnp.asarray(x), jnp.asarray(cb), mesh,
                               axis="tile")
    means = rng.uniform(-1, 1, (D, 256)).astype(np.float32)
    lsc = np.full((D, 256), -2.0, np.float32)
    sym = np.round((means + np.exp(lsc) * rng.logistic(0, 1, means.shape))
                   * 256).astype(np.int32)
    z = (np.clip(sym, -1024 + np.round(means * 256),
                 1023 + np.round(means * 256)).astype(np.float32) / 256.0)
    blobs = sharded_encode(z, means, lsc, mesh, num_streams=8)
    out = sharded_decode(blobs, means, lsc, mesh)
    dense = ((x ** 2).sum(1, keepdims=True) + (cb ** 2).sum(1)
             - 2 * x @ cb.T).argmin(1)
    return {"losses": losses, "params": jax.device_get(fp), "grads": grads,
            "idx": np.asarray(idx), "dense": dense, "blobs": list(blobs),
            "decoded": np.asarray(out), "z": z}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(the 4 ranks' saved results, rank 0's --out file, the JAX side,
    the JAX variables)."""
    tmp = str(tmp_path_factory.mktemp("multichip"))
    from finalproject_losslessimagecompression_tpu_torch import convert

    var = _jax_variables()
    torch.save({"flow": convert.params_from_flax(var["flow"]),
                "uflow": convert.params_from_flax(var["uflow"]),
                "vq": convert.vqvae_params_from_flax(var["vq"])},
               os.path.join(tmp, "inputs.pt"))
    failed = []

    def ranks():
        try:
            spawn_ranks(_rank, D, (tmp,), timeout_s=240.0)
        except Exception as e:  # raised again below, after the JAX side
            failed.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    jax_side = _jax_side(var)
    th.join(timeout=300.0)
    assert not th.is_alive(), "the ranks did not finish"
    if failed:
        raise failed[0]
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(D)]
    with open(os.path.join(tmp, "multichip.json")) as f:
        written = json.load(f)
    return res, written, jax_side, var


def test_entry_loss_matches_jax():
    """`entry`'s fn (forward + bpd loss of the 64x64 IDFlow, nflows 4,
    nsplit 3, DenseBlocks 64 x 4) on JAX's weights, carried over by
    `convert`, equals JAX's fn (`__graft_entry__.py:68-71`) on the same
    batch within 1e-5 relative; its example batch is JAX's draw."""
    import jax
    import jax.numpy as jnp

    from finalproject_losslessimagecompression_tpu import models as JM
    from finalproject_losslessimagecompression_tpu.models.idflow import (
        log_likelihood,
    )
    from finalproject_losslessimagecompression_tpu_torch.convert import (
        params_from_flax,
    )

    nn = JM.DenseBlockCfg(64, 4, "LeakyReLU")
    cfg = JM.FlowCfg(H=64, W=64, C=3, nflows=4, nsplit=3,
                     couple=JM.CouplingCfg(0.75, nn), prior_nn=nn)
    jm = JM.IDFlow(cfg)
    rng = np.random.default_rng(0)
    x = np.round(rng.uniform(0, 1, (4, 64, 64, 3)) * 256).astype(
        np.float32) / 256.0
    var = _drawn(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3))), 4, sd=0.02)
    latents, means, logscales = jm.apply(var, jnp.asarray(x))
    want = float(-jnp.mean(log_likelihood(cfg, latents, means,
                                          logscales)[0]))
    fn, (params, batch) = MC.entry("cpu")
    assert np.array_equal(batch.numpy(), x)
    assert params.keys() == params_from_flax(var).keys()
    with torch.no_grad():
        got = float(fn(params_from_flax(var), batch))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_sharded_step_matches_jax(group):
    """The sharded Adamax step of the residual pipeline over 4 ranks (one,
    as JAX's dry run takes) against JAX's `full_step` jitted over 4
    devices on the same weights and batch: the loss within 1e-5; the
    parameters within 1e-6, except where JAX's gradient is within 1e-3 of
    its largest, where Adamax's normalisation turns the two backends'
    gradient differences into up to 2 lr (at most 1% of the elements);
    the same on all 4 ranks; and the report's own checks (the step equal
    to its eager twin, every element off the plain step near a zero
    gradient) passed."""
    from finalproject_losslessimagecompression_tpu_torch.convert import (
        params_from_flax,
    )

    res, _, jx, _ = group
    want = params_from_flax(jx["params"])
    grads = [params_from_flax(g) for g in jx["grads"]]
    near = {k: np.zeros(v.shape, bool) for k, v in want.items()}
    for g in grads:
        gmax = max(float(v.abs().max()) for v in g.values())
        for k in near:
            near[k] |= g[k].abs().numpy() <= 1e-3 * gmax
    for r in res:
        tr = r["report"]["train"]
        np.testing.assert_allclose(tr["losses"], jx["losses"], rtol=0,
                                   atol=1e-5)
        assert tr["equal_to_eager_twin"] and tr["params_equal_across_ranks"]
        assert tr["against_plain_first_step"]["beyond_1e-6_not_near_zero"] \
            == 0
        assert tr["loss_max_rel_diff"] <= MC.LOSS_RTOL
        assert tr["against_plain"]["beyond_1e-6_not_near_zero"] <= \
            MC.NOT_NEAR_SHARE * tr["against_plain"]["elements"]
        off = total = 0
        for k, v in want.items():
            diff = np.abs(r["flow"][k].numpy() - v.numpy())
            assert not np.any((diff > 1e-6) & ~near[k]), k
            assert np.all(diff <= 2 * LR * STEPS + 1e-6), k
            off += int(np.sum(diff > 1e-6))
            total += diff.size
        assert off <= 0.01 * total, (off, total)
    for k in want:
        for r in res[1:]:
            assert torch.equal(r["flow"][k], res[0]["flow"][k]), k


def test_vq_lookup_over_tile_matches_jax(group):
    """sharded_vq_lookup over the `tile` ranks of mesh (2, 2) (each scores
    32 of the 64 codewords): the indices of JAX's 16 N(0, 1) queries equal
    JAX's lookup over the same mesh and the dense argmin, on every rank."""
    res, _, jx, _ = group
    assert np.array_equal(jx["idx"], jx["dense"])
    for r in res:
        vq = r["report"]["vq"]["normal"]
        assert vq["indices"] == jx["idx"].tolist()
        assert vq["indices_equal_dense"] and vq["rows_equal"]


def test_sharded_rans_decodes_exactly_in_both_packages(group):
    """Chip-local sharded rANS on JAX's dry-run symbols: every rank's
    container is byte-identical to its single-process encode and the
    decode is exact; JAX's containers of the same symbols decode exactly
    in JAX, and the two packages' bytes agree within 1% (the symbols are
    not filtered for CDF agreement, ROADMAP section 3, so the bytes may
    differ)."""
    res, _, jx, _ = group
    assert np.array_equal(jx["decoded"], jx["z"])
    jbytes = sum(map(len, jx["blobs"]))
    for r in res:
        rans = r["report"]["rans"]
        assert rans["exact"] and rans["byte_identical_solo"]
        assert rans["containers"] == D
        assert abs(rans["bytes"] - jbytes) <= 0.01 * jbytes


def test_sharded_codecs_byte_identical_and_exact(group):
    """ShardedFlowCodec ("fused") and ShardedResidualCodec over 4 ranks:
    every rank's containers (and VQ index stream) byte-identical to a
    "level" codec's single-process encode of its shard, every decode
    exact; D x nsplit containers in the JAX flow class's plan (read off
    its codec without compiling it), D index streams."""
    from finalproject_losslessimagecompression_tpu import models as JM
    from finalproject_losslessimagecompression_tpu.parallel import make_mesh
    from finalproject_losslessimagecompression_tpu.parallel.flow_codec import (  # noqa: E501
        ShardedFlowCodec,
    )

    import jax

    res, _, _, _ = group
    _, uflow, _, _ = _jax_models()
    jcodec = JM.FlowCodec(uflow, num_streams=64, granularity="fused")
    fold = ShardedFlowCodec(jcodec, make_mesh(
        (2, 2), devices=jax.devices()[:D]))._local_fold(D)
    nsplit = jcodec.cfg.nsplit
    for r in res:
        rep = r["report"]
        for part in ("flow_codec", "residual_codec"):
            assert rep[part]["exact"] and rep[part]["byte_identical_solo"]
            assert rep[part]["containers"] == D * nsplit
            assert 0 < rep[part]["real_bpd"] < 16
        assert rep["flow_codec"]["granularity"] == "fused"
        assert rep["residual_codec"]["index_streams"] == D
        assert rep["flow_codec"]["kernel_shapes"] == sorted(
            [S, IL._plan_steps(fold * p.z_ch * p.h * p.w, S), level > 0]
            for level, p in enumerate(jcodec.plans)
            for S in [jcodec._level_S(level, fold)])


def test_collective_host_time_under_gloo(group):
    """Over gloo the report carries the mesh's host seconds in collectives
    (non-zero: the step all_reduces its gradients) and no device time,
    which only NCCL's kernels give; the mesh is (2, 2) over gloo."""
    for r in group[0]:
        rep = r["report"]
        assert rep["backend"] == "gloo" and rep["mesh"] == {"data": 2,
                                                           "tile": 2}
        assert rep["train"]["collective_host_ms"] > 0
        assert "collective_device_ms" not in rep["train"]
        assert not rep["train"]["captured"]  # gloo steps run eagerly


def test_kernels_held_against_plain_at_every_launch_shape(group):
    """Every (S, k, seeded) the three coding parts launch at is held
    against the plain coder (here both sides are the plain versions: the
    tensors lie on the CPU), and each rank's launch counts are gathered
    (0 on the CPU)."""
    for r in group[0]:
        rep = r["report"]
        shapes = {tuple(s) for part in ("rans", "flow_codec",
                                        "residual_codec")
                  for s in rep[part]["kernel_shapes"]}
        rows = rep["kernels_against_plain"]
        assert {(x["S"], x["k"], x["seeded"]) for x in rows} == shapes
        assert all(x["decode_exact"] and x["encode_max_abs_err"] == 0
                   for x in rows)
        assert len(rep["launches_per_rank"]) == D
        assert all(v == 0 for per in rep["launches_per_rank"]
                   for part in per.values() for d in part.values()
                   for v in d.values())


def test_rank0_writes_its_report_and_ranks_import_no_jax(group):
    """Rank 0 writes its report to --out (the cards named: here the CPU);
    the entry loss is finite; no rank process imported JAX."""
    res, written, _, _ = group
    assert written == json.loads(json.dumps(res[0]["report"]))
    assert written["cards"] == ["cpu"] * D and written["size"] == "parity"
    assert np.isfinite(written["entry_loss"])
    for r in res:
        assert r["jax_loaded"] == [], r["jax_loaded"]


def test_weak_scaling_stamp_names_the_cards():
    """cli.scaling stamps weak scaling on hardware measured only where
    every rank had a card of its own and there were at least two; the
    stamp names each card and the backend."""
    h100 = "NVIDIA H100 80GB HBM3, 700.00 W"
    four = [(f"GPU-{i}", h100) for i in range(4)]
    stamp = scaling.weak_scaling_stamp(four, "nccl")
    assert stamp.startswith("measured on 4 cards of their own")
    assert stamp.count(h100) == 4 and stamp.endswith("backend nccl")
    for cards in ([four[0]], [four[0], four[0]], [None, None],
                  four[:2] + [four[0], four[1]]):
        assert scaling.weak_scaling_stamp(cards, "gloo").startswith(
            "unmeasured")


@pytest.mark.parametrize("main", [MC.main, scaling.main])
def test_fewer_cards_than_ranks_raises_before_spawning(monkeypatch, main):
    """demo.multichip and cli.scaling need a card a rank under NCCL: with
    one card and 4 ranks they raise before spawning anything, and with no
    card at all they raise too; nothing falls back to gloo or the CPU."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 ranks need a card each"):
        main(["--nproc", "4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--nproc", "4"])
