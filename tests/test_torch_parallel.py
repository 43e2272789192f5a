"""The port's scale-out (`parallel/`) held against the JAX package and
against its own single-device codecs and trainers.

One group of 2 gloo ranks on the CPU is spawned for the whole module
(`torch.multiprocessing`, a FileStore under the test's temporary
directory, a 60 s group timeout).  Each rank runs every check below on
the same inputs, made here with numpy from seeds (the flow and VQ-VAE
weights are the JAX package's, perturbed off zero and carried over with
`convert`), and saves its results; each test reads both ranks' results.
The JAX side runs in this process over `jax.devices()[:2]` of the 8
virtual CPU devices, as a mesh of the same shape as the port's group.
The rank processes import no JAX: the module imports it only inside the
tests.  Small sizes: 8x8 to 16x16 images, nflows 2, growth 8.
"""

import os
import sys
import time
import traceback

import numpy as np
import pytest
import torch

from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch.parallel import mesh as PM

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3)
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 2
TIMEOUT_S = 60.0


def _nn():
    return dict(name="DenseBlock", growth_channel=8, depth=2,
                layer=dict(name="DenseLayer", act="LeakyReLU"))


def _flow_dict(H, W, nsplit=1, scale=2, name="IDFlows", **extra):
    rnd = dict(name="Round", nbits=8)
    return dict(name=name, nflows=2, nbits=8, nsplit=nsplit, H=H, W=W, C=3,
                couple=dict(name="AdditiveCouple", split=0.75, nn=_nn(),
                            round=rnd),
                extenddim=dict(name="ExtendDim", scale=scale),
                prior=dict(name="Prior", round=rnd, nn=_nn()),
                distribution=dict(name="DLogistic"), round=rnd, **extra)


VQ_DICT = dict(
    name="VQVAE", channel=3, embed_num=16, embed_dim=8, hidden_dims=[8, 16],
    encoder=dict(name="VQEncoder", block_num=1,
                 block=dict(name="ResBlock", batch_norm=False)),
    decoder=dict(name="VQDecoder", block_num=1,
                 block=dict(name="ResBlock", batch_norm=False)),
    distribution=dict(name="BinomialDistribution"),
    vectorquantizer=dict(reinit_interval=1000, threshold=0.1),
)
# BatchNorm on, and a reinit interval the first step's counts exceed
VQ_BN_DICT = dict(VQ_DICT, batch_norm=True,
                  vectorquantizer=dict(reinit_interval=0.5, threshold=0.1))
RES_FLOW = _flow_dict(8, 8, nsplit=2, name="ConditionalFlows",
                      conv_for_cond=True)
TL_DICT = dict(name="TwoLevelFlows", H=15, W=15, C=3, pad=[1, 1],
               rough_flows=_flow_dict(4, 4), fine_flows=_flow_dict(8, 8))
VQ_LR, SGD_LR = 0.01, 0.05
VQ_ARGS = dict(alpha=1.0, beta=0.1, gamma=0.25)


def _grid(seed, shape):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(0, 1, shape) * 256) / 256).astype(
        np.float32)


def _data(seed=1, size=16, batch=4, length=8, train=True):
    return dict(name="CustomDataLoader", batch_size=batch, nbits=8,
                train=train, shuffle=train,
                dataset=dict(name="SyntheticImages", size=[size, size, 3],
                             length=length, seed=seed))


def _trainer_cfg(tmp, name, **over):
    cfg = dict(train_dataloader=_data(),
               test_dataloader=_data(train=False),
               optimizer=dict(name="SGD", lr=SGD_LR),
               scheduler=dict(name="Constant"), max_step=1,
               step_per_epoch=1000, evaluate_interval=1000,
               save_interval=1000, save_path=os.path.join(tmp, name + ".ckpt"),
               writer_path=os.path.join(tmp, name + "_log"))
    cfg.update(over)
    return cfg


def _perturbed(model, seed):
    """Fresh projections are zero: perturb them from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".proj." in name:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


def _flow_cfg(M):
    nn = M.DenseBlockCfg(8, 2, "LeakyReLU")
    return M.FlowCfg(H=8, W=8, C=3, nflows=2, nsplit=1,
                     couple=M.CouplingCfg(0.75, nn), prior_nn=nn)


def _codec_cfg(M):
    nn = M.DenseBlockCfg(8, 2, "LeakyReLU")
    return M.FlowCfg(H=16, W=16, C=3, nflows=2, nsplit=2,
                     couple=M.CouplingCfg(0.75, nn), prior_nn=nn)


# ---------------------------------------------------------------------------
# what every rank runs
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _sd(module):
    return {k: _np(v) for k, v in module.state_dict().items()}


def check_mesh(r, inp, data, tile):
    t = torch.tensor([r + 1.0])
    return {"data": (dict(data.shape), data.rank, data.coords),
            "tile": (dict(tile.shape), tile.rank, tile.coords),
            "sum": float(data.all_reduce(t)[0]),
            "sum_tile_of_data_mesh": float(data.all_reduce(t,
                                                           axis="tile")[0]),
            "sum_tile": float(tile.all_reduce(t, axis="tile")[0]),
            "max": float(tile.all_reduce(t, "max")[0]),
            "gather": _np(data.all_gather(t)),
            "objects": data.all_gather_object(("rank", r)),
            "agree_mine_only": data.agree(r == 0),
            "idempotent": str(PM.init_distributed(device="cpu"))}


def check_train_step(r, inp, data, tile):
    from finalproject_losslessimagecompression_tpu_torch.models.idflow import (  # noqa: E501
        log_likelihood,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel import (
        make_sharded_eval_step,
        make_sharded_train_step,
    )
    from finalproject_losslessimagecompression_tpu_torch.train.optim import (
        build_optimizer,
    )

    model = TM.IDFlow(_flow_cfg(TM), device="cpu")
    model.load_state_dict(inp["flow_sd"])
    opt = build_optimizer(model.parameters(), dict(name="Adamax", lr=1e-3),
                          None, 1)
    eval_loss = make_sharded_eval_step(model, data)(inp["flow_x"])
    loss = make_sharded_train_step(model, opt, data)(inp["flow_x"])
    # the plain step on the global batch, in this process
    plain = TM.IDFlow(_flow_cfg(TM), device="cpu")
    plain.load_state_dict(inp["flow_sd"])
    popt = build_optimizer(plain.parameters(), dict(name="Adamax", lr=1e-3),
                           None, 1)
    lat, means, logscales = plain(torch.from_numpy(inp["flow_x"]))
    (-log_likelihood(plain.cfg, lat, means, logscales)[0].mean()).backward()
    popt.step()
    return {"eval_loss": float(eval_loss), "loss": float(loss),
            "params": _sd(model), "plain": _sd(plain)}


def check_vq(r, inp, data, tile):
    from finalproject_losslessimagecompression_tpu_torch.parallel import (
        psum_counts,
        sharded_vq_lookup,
    )

    vq, idx = sharded_vq_lookup(inp["vq_x"], inp["vq_cb"], tile)
    vq1, idx1 = sharded_vq_lookup(inp["vq_x"], inp["vq_cb"], data)
    return {"vq": _np(vq), "idx": _np(idx), "vq_tile1": _np(vq1),
            "idx_tile1": _np(idx1),
            "counts": _np(psum_counts(inp["counts"], data))}


def check_encode(r, inp, data, tile):
    from finalproject_losslessimagecompression_tpu_torch.codec.coder import (
        encode_tensor,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel import (
        sharded_decode,
        sharded_encode,
    )

    z, m, ls = inp["enc_z"], inp["enc_m"], inp["enc_ls"]
    blobs = sharded_encode(z, m, ls, data, num_streams=16)
    b = z.shape[0] // D
    sl = slice(r * b, (r + 1) * b)
    solo = encode_tensor(*(torch.from_numpy(a[sl]) for a in (z, m, ls)), 16)
    out = {"blobs": blobs, "solo": solo,
           "decoded": _np(sharded_decode(blobs, m, ls, data))}
    # the last byte (the escape count: a malformed container) and a
    # payload word (a state that does not return to 2^32) of rank 1's
    for name, pos in (("tail", -1), ("word", 40)):
        bad = bytearray(blobs[1])
        bad[pos] ^= 0xFF
        t0 = time.time()
        try:
            sharded_decode([blobs[0], bytes(bad)], m, ls, data)
            out[name] = "decoded"
        except ValueError as e:
            out[name] = "ValueError: " + str(e)
        out[name + "_s"] = time.time() - t0
    return out


def check_flow_codec(r, inp, data, tile):
    from finalproject_losslessimagecompression_tpu_torch.parallel.flow_codec import (  # noqa: E501
        ShardedFlowCodec,
    )

    model = TM.IDFlow(_codec_cfg(TM), device="cpu")
    model.load_state_dict(inp["fc_sd"])
    codec = TM.FlowCodec(model.eval(), num_streams=256)
    x = inp["fc_x"]
    sharded = ShardedFlowCodec(codec, data)
    blobs, info = sharded.compress(x)
    b = x.shape[0] // D
    solo, _ = codec.compress(x[r * b:(r + 1) * b])
    other = 1 - r
    ns = model.cfg.nsplit
    alone = codec.decompress(blobs[other * ns:(other + 1) * ns],
                             {"batch": b}, fetch=True)
    return {"blobs": blobs, "info": info, "solo": solo,
            "decoded": sharded.decompress(blobs, info, fetch=True),
            "alone": alone, "real_bpd": sharded.real_bpd(blobs, info)}


def check_residual_codec(r, inp, data, tile):
    from finalproject_losslessimagecompression_tpu_torch.parallel.full_codecs import (  # noqa: E501
        ShardedResidualCodec,
    )

    vq = TM.build_vqvae_from_ref(VQ_DICT, device="cpu")
    vq.load_state_dict(inp["res_vq_sd"])
    flow = TM.IDFlow(TM.FlowCfg.from_ref(RES_FLOW), device="cpu")
    flow.load_state_dict(inp["res_flow_sd"])
    res = TM.ResidualCodec(vq.eval(), TM.FlowCodec(flow.eval(), 64),
                           (16, 16))
    x = inp["res_x"]
    sharded = ShardedResidualCodec(res, data)
    idx_blobs, blobs, info = sharded.compress(x)
    b = x.shape[0] // D
    solo = res.compress(x[r * b:(r + 1) * b])
    other, ns = 1 - r, flow.cfg.nsplit
    alone = res.decompress(idx_blobs[other],
                           blobs[other * ns:(other + 1) * ns],
                           {"batch": info["batch"] // D, "images": b},
                           fetch=True)
    return {"idx_blobs": idx_blobs, "blobs": blobs, "info": info,
            "solo": solo[:2],
            "decoded": sharded.decompress(idx_blobs, blobs, info,
                                          fetch=True),
            "alone": alone,
            "real_bpd": sharded.real_bpd(idx_blobs, blobs, info)}


def check_twolevel_codec(r, inp, data, tile):
    from finalproject_losslessimagecompression_tpu_torch.parallel.full_codecs import (  # noqa: E501
        ShardedTwoLevelCodec,
    )

    model = TM.TwoLevelFlow(TM.TwoLevelCfg.from_ref(TL_DICT), device="cpu")
    model.load_state_dict(inp["tl_sd"])
    codec = TM.TwoLevelCodec(model.eval(), num_streams=32)
    x = inp["tl_x"]
    sharded = ShardedTwoLevelCodec(codec, data)
    blobs, info = sharded.compress(x)
    b = x.shape[0] // D
    solo, _ = codec.compress(x[r * b:(r + 1) * b])
    other = 1 - r
    alone = codec.decompress(
        sharded.device_slice(blobs, other),
        {"batch": b, "rough": {"batch": info["rough"]["batch"] // D},
         "fine": {"batch": info["fine"]["batch"] // D}}, fetch=True)
    return {"blobs": blobs, "info": info, "solo": solo,
            "slices": [sharded.device_slice(blobs, d) for d in range(D)],
            "decoded": sharded.decompress(blobs, info, fetch=True),
            "alone": alone, "real_bpd": sharded.real_bpd(blobs, info)}


def check_vqvae_trainer(r, inp, data, tile):
    from finalproject_losslessimagecompression_tpu_torch.train import (
        VQVAETrainer,
    )

    t = VQVAETrainer(**_trainer_cfg(
        inp["tmp"], f"vq{r}", model=VQ_BN_DICT, train_args=VQ_ARGS,
        optimizer=dict(name="SGD", lr=VQ_LR)), use_mesh=True, device="cpu")
    t.model.load_state_dict(inp["vqt_sd"])
    cb0 = _np(t.model.vq.codebook).copy()
    loss, recloss, vqloss, did, nrep = t.update(inp["vqt_x"])
    return {"mesh": t.mesh is not None, "loss": float(loss),
            "did": bool(did), "nrep": int(nrep), "cb0": cb0,
            "counts": _np(t.counts), "state": _sd(t.model)}


def _residual_trainer(inp, name, use_mesh, patches=False):
    """The conditional flow on the VQ-VAE's residual, or (patches) an
    unconditional flow on the image patches (`nouse_vqvae`)."""
    from finalproject_losslessimagecompression_tpu_torch.train import (
        ResidualTrainer,
    )

    flows = _flow_dict(8, 8, nsplit=2) if patches else RES_FLOW
    t = ResidualTrainer(**_trainer_cfg(
        inp["tmp"], name, flows=flows,
        vqvae=dict(VQ_DICT, checkpoint=inp["res_vq_ckpt"]),
        input_size=[16, 16], patch_batch_size=6, nouse_vqvae=patches,
        test_coding=True, num_streams=64), use_mesh=use_mesh, device="cpu")
    if not patches:
        t.model.load_state_dict(inp["res_flow_sd"])
    return t


def check_residual_trainer(r, inp, data, tile):
    """One sharded step against a plain trainer's on the global batch, then
    eval (coded through ShardedResidualCodec) against the plain eval; and
    the eval of the patch codec (every rank coding the global batch)."""
    sharded = _residual_trainer(inp, f"res{r}", True)
    plain = _residual_trainer(inp, f"res_plain{r}", False)
    x = torch.from_numpy(inp["res_x"])
    b = x.shape[0] // D
    loss, _ = sharded.train_step(x[r * b:(r + 1) * b])
    want, _ = plain.train_step(x)
    out = {"loss": float(loss), "want": float(want),
           "state": _sd(sharded.model), "want_state": _sd(plain.model)}
    for name, t in (("eval", sharded), ("want_eval", plain),
                    ("patch_eval", _residual_trainer(inp, f"rp{r}", True,
                                                     True)),
                    ("patch_want_eval", _residual_trainer(
                        inp, f"rp_plain{r}", False, True))):
        ev = t.evaluate()
        out[name] = {k: ev[k] for k in ("test_bpd", "rec_error", "real_bpd",
                                        "coding_errors")}
    return out


def check_twolevel_trainer(r, inp, data, tile):
    from finalproject_losslessimagecompression_tpu_torch.train import (
        TwoLevelTrainer,
    )

    def make(name, use_mesh):
        t = TwoLevelTrainer(**_trainer_cfg(
            inp["tmp"], name, model=TL_DICT,
            train_dataloader=_data(size=15),
            test_dataloader=_data(size=15, train=False),
            test_coding=True, num_streams=32), use_mesh=use_mesh,
            device="cpu")
        t.model.load_state_dict(inp["tl_sd"])
        return t

    sharded, plain = make(f"tl{r}", True), make(f"tl_plain{r}", False)
    x = torch.from_numpy(_grid(77, (4, 15, 15, 3)))
    loss, aux = sharded.train_step(x[r * 2:(r + 1) * 2])
    want, want_aux = plain.train_step(x)
    return {"loss": float(loss), "want": float(want),
            "bpds": sharded._bpds(aux), "want_bpds": plain._bpds(want_aux),
            "eval": sharded.evaluate(), "want_eval": plain.evaluate(),
            "state": _sd(sharded.model), "want_state": _sd(plain.model)}


def check_cli_train(r, inp, data, tile):
    from finalproject_losslessimagecompression_tpu_torch.cli import train
    from finalproject_losslessimagecompression_tpu_torch.parallel.multiproc import (  # noqa: E501
        params_sha256,
    )

    out = os.path.join(inp["tmp"], "cli")
    sets = ["max_step=2", "step_per_epoch=2", "evaluate_interval=2",
            "save_interval=2", "max_eval_batches=1", "num_streams=64",
            "use_mesh=true", "train_dataloader.shard=true",
            "test_dataloader.shard=true", f"save_path={out}/m.ckpt",
            f"writer_path={out}/log"]
    argv = ["--config", os.path.join(REPO, "configs", "smoke_synthetic.yaml"),
            "--device", "cpu", "--distributed"]
    for kv in sets:
        argv += ["--set", "train." + kv]
    t = train.main(argv)
    return {"step": t.step, "mesh": t.mesh is not None,
            "shard": (t.trainloader.shard_index, t.trainloader.shard_count),
            "sha": params_sha256(t.model)}


def check_no_jax(r, inp, data, tile):
    return {"loaded": sorted(
        m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "flax", "finalproject_losslessimagecompression_tpu"))}


CHECKS = [check_mesh, check_train_step, check_vq, check_encode,
          check_flow_codec, check_residual_codec, check_twolevel_codec,
          check_vqvae_trainer, check_residual_trainer,
          check_twolevel_trainer, check_cli_train, check_no_jax]


def _rank_main(r, tmp):
    """One rank: join the group, run every check, save the results."""
    import torch.distributed as dist

    # the metrics writer would import TensorBoard (seconds, and TensorFlow
    # where it is installed); nothing here reads its event files
    sys.modules["torch.utils.tensorboard"] = None
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), D)
    PM.init_distributed("gloo", "cpu", timeout_s=TIMEOUT_S, store=store,
                        rank=r, world_size=D)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    data = PM.make_mesh((2, 1), device="cpu")
    tile = PM.make_mesh((1, 2), device="cpu")
    out = {}
    for check in CHECKS:
        t0 = time.time()
        try:
            out[check.__name__] = check(r, inp, data, tile)
        except Exception:  # recorded, and the test of the check fails
            out[check.__name__] = {"error": traceback.format_exc()}
        out[check.__name__ + "_s"] = time.time() - t0
    torch.save(out, os.path.join(tmp, f"rank{r}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the inputs, the group, and the JAX side
# ---------------------------------------------------------------------------


def _jax_inputs(tmp):
    """Every rank's inputs and the flax variables the JAX side uses."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_coder import _agreeing_symbols
    from test_torch_residual import _perturb

    from finalproject_losslessimagecompression_tpu import models as JM
    from finalproject_losslessimagecompression_tpu.models import vqvae as jvq
    from finalproject_losslessimagecompression_tpu_torch import convert

    rng = np.random.default_rng(0)
    flow_x = _grid(1, (8, 8, 8, 3))
    jflow = JM.IDFlow(_flow_cfg(JM))
    flow_var = _perturb(jax.jit(jflow.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(flow_x)), 7)
    jvqm = jvq.build_vqvae_from_ref(VQ_BN_DICT)
    vq_var = _perturb(jax.jit(jvqm.init)(jax.random.PRNGKey(3),
                                         jnp.zeros((1, 16, 16, 3))), 4)
    vq_var["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, vq_var["batch_stats"])
    v, m, ls = _agreeing_symbols(rng, 4 * 64)

    res_vq = TM.build_vqvae_from_ref(VQ_DICT, device="cpu", seed=1)
    res_flow = _perturbed(TM.IDFlow(TM.FlowCfg.from_ref(RES_FLOW),
                                    device="cpu", seed=2), 3)
    fc = _perturbed(TM.IDFlow(_codec_cfg(TM), device="cpu", seed=0), 1)
    tl = _perturbed(TM.TwoLevelFlow(TM.TwoLevelCfg.from_ref(TL_DICT),
                                    device="cpu", seed=0), 5)
    res_vq_ckpt = os.path.join(tmp, "res_vq.ckpt")
    torch.save({"params": res_vq.state_dict()}, res_vq_ckpt)
    inp = {
        "tmp": tmp,
        "flow_sd": convert.params_from_flax(flow_var), "flow_x": flow_x,
        "vq_x": rng.normal(0, 1, (40, 16)).astype(np.float32),
        "vq_cb": rng.normal(0, 1, (64, 16)).astype(np.float32),
        "counts": rng.uniform(0, 1, (8, 32)).astype(np.float32),
        "enc_z": (v.astype(np.float32) / 256.0).reshape(4, 64),
        "enc_m": m.reshape(4, 64), "enc_ls": ls.reshape(4, 64),
        "fc_sd": fc.state_dict(), "fc_x": _grid(2, (2 * D, 16, 16, 3)),
        "res_vq_sd": res_vq.state_dict(),
        "res_flow_sd": res_flow.state_dict(), "res_vq_ckpt": res_vq_ckpt,
        "res_x": _grid(3, (2 * D, 16, 16, 3)),
        "tl_sd": tl.state_dict(), "tl_x": _grid(4, (D, 15, 15, 3)),
        "vqt_sd": convert.vqvae_params_from_flax(vq_var),
        "vqt_x": _grid(5, (4, 16, 16, 3)),
    }
    return inp, {"flow": (jflow, flow_var), "vq": (jvqm, vq_var)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(rank 0's results, rank 1's results, inputs, flax variables)."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("parallel"))
    inp, jax_vars = _jax_inputs(tmp)
    torch.save(inp, os.path.join(tmp, "inputs.pt"))
    ctx = mp.start_processes(_rank_main, (tmp,), nprocs=D, join=False,
                             start_method="spawn")
    deadline = time.time() + 4 * TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.time())):
            if time.time() >= deadline:
                raise TimeoutError("the ranks did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(D)]
    return res, inp, jax_vars


def _results(group, name):
    res = [r[name] for r in group[0]]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _jmesh(shape):
    import jax

    from finalproject_losslessimagecompression_tpu.parallel import make_mesh

    return make_mesh(shape, devices=jax.devices()[:D])


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_mesh_shape_for_matches_jax():
    """mesh_shape_for(n) equals the JAX package's for n in 1..64."""
    from finalproject_losslessimagecompression_tpu.parallel import mesh as jm

    for n in range(1, 65):
        assert PM.mesh_shape_for(n) == jm.mesh_shape_for(n), n


def test_init_distributed_needs_the_torchrun_variables(monkeypatch):
    """Without RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (and without
    rank= / store=), init_distributed raises naming them; it never falls
    back to one process, and no group is left behind."""
    import torch.distributed as dist

    for v in PM._TORCHRUN_VARS:
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        PM.init_distributed(device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        PM.make_mesh(device="cpu")
    assert not dist.is_initialized()


def test_mesh_coordinates_and_collectives(group):
    """Rank r of mesh (2, 1) is data r, tile 0; of mesh (1, 2) data 0,
    tile r.  Sums, maxima and gathers over the mesh and over its `tile`
    ranks (one rank in mesh (2, 1)) are exact, a failure on one rank is
    agreed by both, and init_distributed re-entered returns the device."""
    res = _results(group, "check_mesh")
    for r, out in enumerate(res):
        assert out["data"] == ({"data": 2, "tile": 1}, r,
                               {"data": r, "tile": 0})
        assert out["tile"] == ({"data": 1, "tile": 2}, r,
                               {"data": 0, "tile": r})
        assert out["sum"] == 3.0 and out["sum_tile"] == 3.0
        assert out["sum_tile_of_data_mesh"] == r + 1.0
        assert out["max"] == 2.0
        assert np.array_equal(out["gather"], [[1.0], [2.0]])
        assert out["objects"] == [("rank", 0), ("rank", 1)]
        assert out["agree_mine_only"] is False
        assert out["idempotent"] == "cpu"


def test_sharded_train_step_matches_jax(group):
    """One sharded Adamax step over 2 ranks against the JAX package's
    make_sharded_train_step over 2 devices (same weights, same batch of
    8): loss within 1e-5; params within 1e-6 after the step, except where
    the gradient is within the two backends' rounding of zero (|g| <=
    1e-4 of the largest): Adamax's first step, lr g / (|g| + 1e-8), turns
    their ~1e-8 gradient differences into up to 2 lr there (at most 1% of
    the elements); equal on both ranks, and within 1e-6 of the plain
    step on the global batch everywhere; make_sharded_eval_step's loss
    within 1e-5 of the JAX one's."""
    import jax
    import jax.numpy as jnp
    import optax

    from finalproject_losslessimagecompression_tpu.parallel import (
        make_sharded_eval_step,
        make_sharded_train_step,
    )
    from finalproject_losslessimagecompression_tpu_torch.convert import (
        params_from_flax,
    )

    res = _results(group, "check_train_step")
    jm, var = group[2]["flow"]
    x = jnp.asarray(group[1]["flow_x"])
    mesh = _jmesh((2, 1))
    params = jax.tree_util.tree_map(jnp.asarray, var)
    opt = optax.adamax(1e-3)
    jeval = make_sharded_eval_step(jm, mesh)(params, x)
    p1, _, loss = make_sharded_train_step(jm, opt, mesh)(
        params, opt.init(params), x)
    want = params_from_flax(jax.device_get(p1))
    grads = params_from_flax(jax.device_get(jax.grad(
        lambda p: _jax_flow_loss(jm, p, x))(params)))
    gmax = max(float(g.abs().max()) for g in grads.values())
    lr = 1e-3
    for out in res:
        assert abs(out["eval_loss"] - float(jeval)) < 1e-5
        assert abs(out["loss"] - float(loss)) < 1e-5
        off = total = 0
        for k, v in want.items():
            diff = np.abs(out["params"][k] - v.numpy())
            near = np.abs(grads[k].numpy()) <= 1e-4 * gmax
            assert not np.any((diff > 1e-6) & ~near), k
            assert np.all(diff <= 2 * lr + 1e-6), k
            off += int(np.sum(diff > 1e-6))
            total += diff.size
            np.testing.assert_allclose(out["params"][k], out["plain"][k],
                                       rtol=0, atol=1e-6, err_msg=k)
        assert off <= 0.01 * total, (off, total)
    for k in want:
        assert np.array_equal(res[0]["params"][k], res[1]["params"][k])


def _jax_flow_loss(jm, params, x):
    from finalproject_losslessimagecompression_tpu.models.idflow import (
        log_likelihood,
    )

    lat, means, logscales = jm.apply(params, x)
    return -log_likelihood(jm.cfg, lat, means, logscales)[0].mean()


def test_sharded_vq_lookup_matches_jax_and_dense(group):
    """sharded_vq_lookup over the `tile` ranks of mesh (1, 2) (each scores
    32 of 64 codewords) and over mesh (2, 1) (one tile rank, the whole
    codebook): indices equal to the JAX package's over the same mesh shape
    and to the dense argmin, rows exactly the winning codewords."""
    import jax.numpy as jnp

    from finalproject_losslessimagecompression_tpu.parallel import (
        sharded_vq_lookup,
    )

    inp = group[1]
    x, cb = inp["vq_x"], inp["vq_cb"]
    d = (np.sum(x ** 2, 1, keepdims=True) + np.sum(cb ** 2, 1)
         - 2 * x @ cb.T)
    dense = np.argmin(d, axis=1)
    _, jidx = sharded_vq_lookup(jnp.asarray(x), jnp.asarray(cb),
                                _jmesh((1, 2)), axis="tile")
    assert np.array_equal(np.asarray(jidx), dense)
    for out in _results(group, "check_vq"):
        for key in ("", "_tile1"):
            assert np.array_equal(out["idx" + key], dense)
            assert np.array_equal(out["vq" + key], cb[dense])


def test_psum_counts_matches_jax(group):
    """psum_counts of [8, 32] per-device counts over 2 ranks (4 rows each)
    equals the JAX package's over 2 devices and the row sum, within
    1e-5."""
    import jax.numpy as jnp

    from finalproject_losslessimagecompression_tpu.parallel import (
        psum_counts,
    )

    counts = group[1]["counts"]
    want = np.asarray(psum_counts(jnp.asarray(counts), _jmesh((2, 1))))
    np.testing.assert_allclose(want, counts.sum(0), atol=1e-5)
    for out in _results(group, "check_vq"):
        assert out["counts"].shape == (32,)
        np.testing.assert_allclose(out["counts"], want, atol=1e-5)


def test_sharded_encode_byte_identical_to_jax(group):
    """sharded_encode on agreement-filtered symbols (4 x 64, 16 streams):
    each rank's container is byte-identical to the JAX package's
    sharded_encode container of the same device and to the port's
    single-device encode of the rank's shard; both ranks hold all."""
    import jax.numpy as jnp

    from finalproject_losslessimagecompression_tpu.parallel import (
        sharded_encode,
    )

    inp = group[1]
    want = sharded_encode(*(jnp.asarray(inp[k]) for k in
                            ("enc_z", "enc_m", "enc_ls")), _jmesh((2, 1)),
                          num_streams=16)
    res = _results(group, "check_encode")
    for r, out in enumerate(res):
        assert out["blobs"] == list(want)
        assert out["solo"] == want[r]


def test_sharded_decode_bit_exact_and_corrupt_raises_everywhere(group):
    """sharded_decode returns the encoded grid values exactly on both
    ranks; a corrupt container of rank 1 (a flipped escape count, or a
    flipped payload word) raises ValueError on BOTH ranks, promptly (no
    rank waits out the 60 s timeout)."""
    res = _results(group, "check_encode")
    z = group[1]["enc_z"]
    for out in res:
        assert np.array_equal(out["decoded"], z)
        for name in ("tail", "word"):
            assert out[name].startswith("ValueError"), out[name]
            assert out[name + "_s"] < TIMEOUT_S / 4


def _blob_plan(blob):
    from finalproject_losslessimagecompression_tpu_torch.codec.container import (  # noqa: E501
        unpack_streams,
    )

    e = unpack_streams(blob)
    return e.n, e.num_streams


def test_sharded_flow_codec_byte_identical_per_rank(group):
    """ShardedFlowCodec over 2 ranks (16x16, nsplit 2, 2 images each):
    rank r's containers are byte-identical to FlowCodec.compress of its
    images, every rank holds all D * nsplit containers in device-major
    order (count and per-position (symbols, streams) equal to the plan the
    JAX class gives its containers over 2 devices), and the sharded
    decompress returns the batch exactly on both ranks."""
    from finalproject_losslessimagecompression_tpu import models as JM
    from finalproject_losslessimagecompression_tpu.parallel.flow_codec import (  # noqa: E501
        ShardedFlowCodec,
    )

    res = _results(group, "check_flow_codec")
    x = group[1]["fc_x"]
    ns = 2
    for r, out in enumerate(res):
        assert out["blobs"][r * ns:(r + 1) * ns] == out["solo"]
        assert out["blobs"] == res[0]["blobs"]
        assert out["info"] == {"batch": 2 * D, "devices": D}
        assert np.array_equal(out["decoded"], x)
        assert 0 < out["real_bpd"] < 16
    # the JAX class's container plan (ShardedFlowCodec.compress), read
    # off its codec without compiling it
    jcodec = JM.FlowCodec(JM.IDFlow(_codec_cfg(JM)), num_streams=256,
                          granularity="fused")
    fold = ShardedFlowCodec(jcodec, _jmesh((2, 1)))._local_fold(len(x))
    plan = [(fold * p.z_ch * p.h * p.w, jcodec._level_S(level, fold))
            for _ in range(D) for level, p in enumerate(jcodec.plans)]
    assert [_blob_plan(b) for b in res[0]["blobs"]] == plan


def test_sharded_flow_codec_shard_decodes_alone(group):
    """Each rank decodes the OTHER rank's containers alone with a plain
    FlowCodec, exactly."""
    x = group[1]["fc_x"]
    for r, out in enumerate(_results(group, "check_flow_codec")):
        other = 1 - r
        assert np.array_equal(out["alone"], x[other * 2:(other + 1) * 2])


def test_sharded_residual_codec_byte_identical_per_rank(group):
    """ShardedResidualCodec over 2 ranks (2 images of 16x16 each, 8x8
    conditional flow tiles, nsplit 2): rank r's VQIX stream and
    containers are byte-identical to ResidualCodec.compress of its images,
    in the JAX class's layout (idx_blobs[d], blobs[d*nsplit + l]); the
    decompress returns the batch exactly on both ranks, and each rank
    decodes the other's shard alone."""
    res = _results(group, "check_residual_codec")
    x = group[1]["res_x"]
    for r, out in enumerate(res):
        assert out["idx_blobs"][r] == out["solo"][0]
        assert out["blobs"][r * 2:(r + 1) * 2] == out["solo"][1]
        assert len(out["idx_blobs"]) == D and len(out["blobs"]) == D * 2
        assert out["info"] == {"batch": 2 * D * 4, "devices": D,
                               "images": 2 * D}
        assert np.array_equal(out["decoded"], x)
        other = 1 - r
        assert np.array_equal(out["alone"], x[other * 2:(other + 1) * 2])
        assert 0 < out["real_bpd"] < 64


def test_sharded_twolevel_codec_byte_identical_per_rank(group):
    """ShardedTwoLevelCodec over 2 ranks (one 15x15 image each): D rough
    containers then D fine ones, rank d's slice (this class's
    device_slice and the JAX class's, run on the same list) byte-identical
    to TwoLevelCodec.compress of its image; the decompress returns the
    batch exactly, and each rank decodes the other's slice alone."""
    from types import SimpleNamespace

    from finalproject_losslessimagecompression_tpu.parallel.full_codecs import (  # noqa: E501
        ShardedTwoLevelCodec as JShardedTwoLevel,
    )

    res = _results(group, "check_twolevel_codec")
    x = group[1]["tl_x"]
    cfg = SimpleNamespace(rough=SimpleNamespace(nsplit=1),
                          fine=SimpleNamespace(nsplit=1))
    jax_like = SimpleNamespace(tl=SimpleNamespace(cfg=cfg), D=D)
    for r, out in enumerate(res):
        assert len(out["blobs"]) == D * 2
        assert out["slices"][r] == out["solo"]
        for d in range(D):
            assert JShardedTwoLevel.device_slice(
                jax_like, out["blobs"], d) == out["slices"][d]
        assert np.array_equal(out["decoded"], x)
        assert np.array_equal(out["alone"], x[1 - r:2 - r])
        assert 0 < out["real_bpd"] < 64


def test_vqvae_trainer_sharded_step_matches_jax(group):
    """VQVAETrainer with use_mesh over 2 ranks, BatchNorm on, one SGD step
    on a global batch of 4 (2 per rank) with a reinit interval the step's
    counts exceed, against the JAX package's make_vqvae_step over a
    2-device mesh and its reinit_step: the BatchNorm running averages
    (global moments) and every parameter within 1e-5, the usage counts
    within 1e-6, the reinit fired on both sides with the same codewords
    replaced, the codebook after it within 1e-5; equal on both ranks."""
    import jax
    import jax.numpy as jnp

    from finalproject_losslessimagecompression_tpu.train import (
        optim as joptim,
    )
    from finalproject_losslessimagecompression_tpu.train.vqvae_trainer import (  # noqa: E501
        make_vqvae_step,
    )
    from finalproject_losslessimagecompression_tpu_torch import convert

    jm, var = group[2]["vq"]
    x = jnp.asarray(group[1]["vqt_x"])
    mesh = _jmesh((2, 1))
    jopt = joptim.build_optimizer(dict(name="SGD", lr=VQ_LR),
                                  dict(name="Constant"), 1000)
    step, _, reinit = make_vqvae_step(jm, jopt, **VQ_ARGS, mesh=mesh)
    jvar = jax.tree_util.tree_map(jnp.asarray, var)
    p1, _, loss, (_, _, counts, flat) = step(jvar, jopt.init(jvar), x)
    p2, new_counts, did, nrep = reinit(p1, counts, flat, 0.5, 0.1)
    want = convert.vqvae_params_from_flax(jax.device_get(p2))
    res = _results(group, "check_vqvae_trainer")
    cb0 = res[0]["cb0"]
    jcb = want["vq.codebook"].numpy()
    for out in res:
        assert out["mesh"]
        assert abs(out["loss"] - float(loss)) < 1e-5 * abs(float(loss))
        assert out["did"] and bool(did)
        assert out["nrep"] == int(nrep) > 0
        np.testing.assert_allclose(out["counts"], np.asarray(new_counts),
                                   atol=1e-6)
        for k, v in want.items():
            np.testing.assert_allclose(out["state"][k], v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
        got = out["state"]["vq.codebook"]
        moved = np.any(np.abs(got - cb0) > 1e-3, axis=1)
        assert np.array_equal(moved, np.any(np.abs(jcb - cb0) > 1e-3,
                                            axis=1))
    for k in want:
        assert np.array_equal(res[0]["state"][k], res[1]["state"][k])


def test_residual_trainer_sharded_step_and_eval_equal_plain(group):
    """ResidualTrainer with use_mesh over 2 ranks (conditional flow, the
    VQ-VAE from a checkpoint, patch_batch_size 6 of the global batch's 16
    patches): one SGD step equals a plain trainer's step on the global
    batch, loss and parameters within 1e-6, equal on both ranks.  Eval
    over the two 4-image test batches, coded through ShardedResidualCodec,
    and the patch codec's eval (`nouse_vqvae`, every rank coding the
    global batch with the plain codec, as JAX does) give the plain
    trainer's coding errors (0), test bpd and rec error within 1e-6; the
    coded bpd of the sharded codec within 10% of the plain eval's (each
    rank's containers hold half the batch, so the per-container overhead
    differs), the patch codec's equal to it."""
    res = _results(group, "check_residual_trainer")
    for out in res:
        assert abs(out["loss"] - out["want"]) < 1e-6 * abs(out["want"])
        for k, v in out["want_state"].items():
            np.testing.assert_allclose(out["state"][k], v, rtol=0,
                                       atol=1e-6, err_msg=k)
        for got, want in ((out["eval"], out["want_eval"]),
                          (out["patch_eval"], out["patch_want_eval"])):
            assert got["coding_errors"] == want["coding_errors"] == 0
            np.testing.assert_allclose(got["real_bpd"], want["real_bpd"],
                                       rtol=0.1)
            for k in ("test_bpd", "rec_error"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        assert out["patch_eval"]["real_bpd"] == \
            out["patch_want_eval"]["real_bpd"]
    for k in res[0]["state"]:
        assert np.array_equal(res[0]["state"][k], res[1]["state"][k])


def test_twolevel_trainer_sharded_step_and_eval_equal_plain(group):
    """TwoLevelTrainer with use_mesh over 2 ranks: one SGD step equals a
    plain trainer's on the global batch of 4 (loss, both levels' bpd and
    parameters within 1e-6), and eval (ShardedTwoLevelCodec coding) gives
    the plain trainer's bpds within 1e-6, equal on both ranks."""
    res = _results(group, "check_twolevel_trainer")
    for out in res:
        assert abs(out["loss"] - out["want"]) < 1e-6 * abs(out["want"])
        np.testing.assert_allclose(out["bpds"], out["want_bpds"], rtol=1e-6)
        np.testing.assert_allclose(out["eval"], out["want_eval"], rtol=1e-6)
        for k, v in out["want_state"].items():
            np.testing.assert_allclose(out["state"][k], v, rtol=0,
                                       atol=1e-6, err_msg=k)
    assert res[0]["eval"] == res[1]["eval"]


def test_cli_train_distributed_two_ranks(group):
    """cli.train --distributed --device cpu on configs/smoke_synthetic.yaml
    with use_mesh and shard: true in a 2-rank group (joined first, so the
    CLI's init_distributed re-enters): each rank draws its half of every
    epoch, both end at step 2 with the same parameters, and rank 0 alone
    wrote the checkpoint and the metrics (each step once, eval coded
    through ShardedFlowCodec with 0 errors)."""
    import json

    from finalproject_losslessimagecompression_tpu_torch.train import (
        checkpoint,
    )

    res = _results(group, "check_cli_train")
    for r, out in enumerate(res):
        assert out["step"] == 2 and out["mesh"]
        assert out["shard"] == (r, D)
    assert res[0]["sha"] == res[1]["sha"]
    out = os.path.join(group[1]["tmp"], "cli")
    with open(os.path.join(out, "log", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r["step"] for r in recs if r["tag"] == "train loss"]
    assert steps == [1, 2]
    assert [(r["step"], r["value"]) for r in recs
            if r["tag"] == "coding errors"] == [(2, 0.0)]
    assert checkpoint.load_checkpoint(os.path.join(out, "m.ckpt"),
                                      "cpu")["step"] == 2
    assert sorted(os.listdir(out)) == ["log", "m.ckpt"]


def test_rank_processes_import_no_jax(group):
    """The rank processes ran every check without importing jax, flax or
    the JAX package."""
    for out in _results(group, "check_no_jax"):
        assert out["loaded"] == []
