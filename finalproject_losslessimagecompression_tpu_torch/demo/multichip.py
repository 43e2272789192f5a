"""The multi-chip dry run: the counterpart of the repository's
`__graft_entry__.py` (`entry`, `dryrun_multichip`).

`entry(device)` is JAX's single-chip check: a forward + bpd loss function
on a modest 64x64 IDFlow (nflows 4, nsplit 3, DenseBlocks 64 x 4) and its
example arguments (the model's parameters and a seeded batch of 4).

`dryrun_multichip(n)` runs the system's whole scale-out surface once, in
JAX's order, over `make_mesh(mesh_shape_for(n))` ((2, 2) at n = 4), on
every rank of an initialised group of n ranks (one process per device):

1. the sharded residual-pipeline train step: the frozen VQ-VAE's
   reconstruction, `round_to_grid`, `patch_split`, the conditional IDFlow,
   its loss, the gradients averaged over the mesh and an Adamax update
   (`parallel.sharding`), captured as a CUDA graph under NCCL
   (`graphs_allowed`): timed replays and one profiled window of them
   (collective time) on a copy of the flow, then `steps` checked steps;
2. `sharded_vq_lookup` over the `tile` ranks;
3. `sharded_encode` / `sharded_decode` (chip-local rANS);
4. `ShardedFlowCodec` over a "fused" FlowCodec;
5. `ShardedResidualCodec`.

Checks, on every rank, each agreed across the mesh before any rank raises
(`Mesh.check`): the parameters hash the same on every rank after the
steps; the captured step equals an eager twin bit for bit; against the
plain step on the global batch in this process, after the first step
every parameter agrees within 1e-6, except where a gradient is within
rounding of zero (<= 1e-3 of the step's largest), where Adamax's
normalisation may move an element by up to 2 lr (counted, at most 1%);
every step's loss agrees with the plain loss within LOSS_RTOL; after the
last step at most NOT_NEAR_SHARE of the elements lie beyond 1e-6 where no
step's gradient was near zero (a flip at a near-zero gradient changes the
next steps' gradients everywhere); the VQ indices equal the dense argmin (ties to the lowest global index); every rank's containers
are byte-identical to a single-process encode of its shard by a codec of
the other granularity ("level"), and every decode is exact; the three
rANS kernels equal their plain versions at every shape they launched at
(their launch counts per rank reported).

Two sizes.  The parity size (the default) is JAX's own
(`__graft_entry__.py:103-117`): an 8x8 conditional flow (nflows 2, nsplit
2, DenseBlocks 16 x 2), a 16x16 VQ-VAE with 64 x 8 codes, a global batch
of 2n, its inputs drawn in JAX's order from numpy's generator of seed 0,
so the CPU tests hold this size against JAX's pieces.  `--full` takes the
widths of configs/resflow-cond-imagenet64.yaml (64x64x3, nflows 8, nsplit
3, couplings 384 x 8, prior 512 x 12, LeakyReLU; VQ-VAE 8192 x 512 with
hidden dims 128/256/512 and 8 ResBlocks), seeded weights with perturbed
projections (`bench.perturbed`) and a batch of 16 images a rank; what it
cuts is listed under `reduced`.

    python -m finalproject_losslessimagecompression_tpu_torch.demo.multichip \\
        [--nproc 4] [--full] [--steps 3] [--device cpu] [--out PATH]

Without the torchrun variables it spawns --nproc ranks on this machine
(`parallel.multiproc.spawn_ranks`): NCCL with a card each by default (it
raises with fewer cards than ranks), gloo ranks on the CPU with `--device
cpu`; under torchrun each process is one rank.  Rank 0 prints one JSON
line (the mesh, each card's name and power limit, the captured step's
seconds, the collective time, the codecs' seconds each way, real_bpd) and
writes it to --out, a file that must not exist yet.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import time
from dataclasses import replace

import numpy as np
import torch
from torch.func import functional_call

from ..bench import clamped_message, coded_shapes, max_err, perturbed
from ..cli import yamlite
from ..codec import cuda_rans
from ..codec import interleaved as IL
from ..codec.coder import encode_tensor
from ..models import (
    CouplingCfg,
    DenseBlockCfg,
    FlowCfg,
    FlowCodec,
    IDFlow,
    ResidualCodec,
    VQVAE,
    build_vqvae_from_ref,
)
from ..models.idflow import log_likelihood, resolve_device
from ..parallel import (
    make_mesh,
    mesh_shape_for,
    shard_batch,
    sharded_decode,
    sharded_encode,
    sharded_vq_lookup,
)
from ..parallel.flow_codec import ShardedFlowCodec
from ..parallel.full_codecs import ShardedResidualCodec
from ..parallel.multiproc import check_cards, params_sha256, spawn_ranks
from ..parallel.sharding import (
    flow_nll,
    graphs_allowed,
    replicate,
    sharded_update,
)
from ..train.optim import build_optimizer
from ..train.residual_trainer import residual_inputs
from ..utils.graphs import optimizer_step
from ..utils.profiling import collective_ms, device_label
from . import ROOT, write_new
from .stress import clock

CONFIG = "configs/resflow-cond-imagenet64.yaml"
LR = 1e-3  # JAX's optax.adamax(1e-3)
NEAR = 1e-3  # a gradient within this share of the step's largest is near 0
# after the checked steps, against the plain step: each loss within this
# relative difference (four H100s: 7.9e-7 at most), and at most this share
# of the elements beyond 1e-6 where no step's gradient was near zero (four
# H100s: 22 of 35,253,420)
LOSS_RTOL = 1e-5
NOT_NEAR_SHARE = 1e-5
# the sizes: images per rank and their side, the flow codec's images per
# rank and their side, symbols per rank of the raw rANS, the flow codecs'
# and the raw rANS's streams, the VQ queries, timed and profiled replays
SIZES = {
    "parity": {"per_rank": 2, "side": 16, "codec_per_rank": 1,
               "codec_side": 8, "rans_per_rank": 256, "flow_streams": 64,
               "rans_streams": 8, "vq_queries": 16, "timed_steps": 3,
               "profiled_steps": 2},
    "full": {"per_rank": 16, "side": 64, "codec_per_rank": 16,
             "codec_side": 64, "rans_per_rank": 16 * 64 * 64 * 3,
             "flow_streams": 4096, "rans_streams": 8192, "vq_queries": 2048,
             "timed_steps": 5, "profiled_steps": 3},
}
REDUCED = [
    "steps: a few captured train steps (the config trains 1,000,000)",
    "weights: seeded, projections perturbed off zero; the VQ-VAE is not "
    "trained (the config loads ./logs/vqvae_imagenet64_reinit.ckpt)",
    "data: uniform noise on the 1/256 grid in place of ImageNet64",
    "batch: 16 images a rank (the config's loader: 4)",
]


def grid(rng, shape) -> np.ndarray:
    """Uniform images on the 1/256 grid (JAX's draw)."""
    return (np.round(rng.uniform(0, 1, shape) * 256).astype(np.float32)
            / 256.0)


def entry(device=None):
    """-> (fn, example_args): forward + bpd loss on a modest 64x64 IDFlow
    (JAX's `entry()`): `fn(params, batch)` with `params` the model's
    state_dict, and a seeded batch of 4 images on the device."""
    device = resolve_device(device)
    nn = DenseBlockCfg(64, 4, "LeakyReLU")
    cfg = FlowCfg(H=64, W=64, C=3, nflows=4, nsplit=3,
                  couple=CouplingCfg(0.75, nn), prior_nn=nn)
    model = IDFlow(cfg, device=device, seed=0)
    x = torch.from_numpy(grid(np.random.default_rng(0),
                              (4, 64, 64, 3))).to(device)

    def fn(params, batch):
        latents, means, logscales = functional_call(model, params, (batch,))
        lp, _ = log_likelihood(cfg, latents, means, logscales)
        return -lp.mean()

    return fn, (dict(model.state_dict()), x)


def parity_models(device):
    """(conditional flow, unconditional flow, VQ-VAE, VQ-VAE input size)
    at JAX's dry-run shapes, seeded, projections perturbed."""
    nn = DenseBlockCfg(16, 2, "LeakyReLU")
    cfg = FlowCfg(H=8, W=8, C=3, nflows=2, nsplit=2,
                  couple=CouplingCfg(0.75, nn), prior_nn=nn,
                  conditional=True)
    vq = VQVAE(channel=3, embed_num=64, embed_dim=8, hidden_dims=(8, 16),
               block_num=1, device=device, seed=1)
    return (perturbed(IDFlow(cfg, device=device, seed=0)),
            perturbed(IDFlow(replace(cfg, conditional=False), device=device,
                             seed=2)), vq.eval(), (16, 16))


def full_models(device):
    """The same four at the widths of configs/resflow-cond-imagenet64.yaml."""
    train = yamlite.load(os.path.join(ROOT, CONFIG))["train"]
    cfg = FlowCfg.from_ref(train["flows"])
    ucfg = replace(cfg, conditional=False, conv_for_cond=False)
    vq = build_vqvae_from_ref(train["vqvae"], device=device, seed=1)
    return (perturbed(IDFlow(cfg, device=device, seed=0)),
            perturbed(IDFlow(ucfg, device=device, seed=2)), vq.eval(),
            tuple(train["input_size"]))


class ResidualStep:
    """One Adamax update of the conditional flow on an image batch (JAX's
    `full_step`): the frozen VQ-VAE's grid-rounded reconstruction, the
    residual and reconstruction in flow patches, the flow's NLL, the
    gradients averaged over `mesh` (the plain update without one).  A
    `GraphedStep` (`graphed`): captured on the card under NCCL where
    `graphs`, eager otherwise; `graphed.eager` is its eager twin."""

    def __init__(self, flow: IDFlow, vqvae: VQVAE, mesh, graphs: bool):
        self.flow, self.vqvae, self.mesh = flow, vqvae, mesh
        if mesh is not None:
            replicate(flow, mesh)
            replicate(vqvae, mesh)
        self.optimizer = build_optimizer(flow.parameters(),
                                         {"name": "Adamax", "lr": LR},
                                         None, 1)
        self.graphed = optimizer_step(
            self._body, self.optimizer, flow.device,
            graphs=graphs and graphs_allowed(mesh))

    def _body(self, batch):
        patches, rec_patches, _ = residual_inputs(self.vqvae, batch,
                                                  self.flow.cfg)
        loss = flow_nll(self.flow, patches, rec_patches, True)
        return sharded_update(loss, self.optimizer, self.mesh,
                              self.optimizer.lrs(1)[0])


def fenced(fn, device):
    """(fn(), seconds), device work included."""
    stop = clock(device)
    out = fn()
    return out, stop()


def counted(fn, device):
    """(fn(), seconds, the three kernels' launches during it)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out, s = fenced(fn, device)
    return out, s, {n: w.launches for n, w in wrappers.items()}


def release(device) -> None:
    """Free what a finished part held: a captured step and its graph sit
    in a reference cycle (the step holds its body, a bound method of the
    object that holds the step), so they go at a collection, and with
    them the graph's memory pool."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def kernel_wrappers():
    return {"rans_cdf_prepass_kernel": cuda_rans.rans_cdf_prepass,
            "rans_encode_kernel": cuda_rans.rans_encode,
            "rans_decode_kernel": cuda_rans.rans_decode}


def time_step(mesh, flow, vq, local, sizes: dict) -> dict:
    """The captured sharded step on its own copy of the flow: warmed up
    (the eager first call, then the capture), `timed_steps` replays timed
    and `profiled_steps` more in one window for the collective time."""
    step = ResidualStep(flow, vq, mesh, graphs=True)
    for _ in range(2):
        float(step.graphed(local))
    n = sizes["timed_steps"]
    _, s = fenced(lambda: [step.graphed(local) for _ in range(n)],
                  flow.device)
    out = {"step_s": s / n, "timed_steps": n}
    n = sizes["profiled_steps"]
    out.update(collective_ms(
        mesh, lambda: [step.graphed(local) for _ in range(n)], n))
    return out


def against_plain(flow, plain_flow, near) -> dict:
    """Elements of the sharded flow beyond 1e-6 of the plain one, those of
    them where no gradient was near zero, the largest difference."""
    off = not_near = total = 0
    worst = 0.0
    for p, q, m in zip(flow.parameters(), plain_flow.parameters(), near):
        diff = (p.detach() - q.detach()).abs()
        total += diff.numel()
        off += int((diff > 1e-6).sum())
        not_near += int(((diff > 1e-6) & ~m).sum())
        worst = max(worst, float(diff.max()))
    return {"elements": total, "beyond_1e-6": off,
            "beyond_1e-6_not_near_zero": not_near, "max_abs_diff": worst}


def train_check(mesh, models, x, steps: int, sizes: dict) -> dict:
    """Part 1: the step timed on a copy of the flow (`time_step`), then
    `steps` captured sharded steps of the flow itself against an eager
    twin (bit for bit) and the plain step on the global batch x: after
    the first step every element within 1e-6 but where a gradient was
    near zero, there within 2 lr (at most 1% of the elements); every
    step's loss within LOSS_RTOL of the plain loss; after the last, at
    most NOT_NEAR_SHARE of the elements beyond 1e-6 where no step's
    gradient was near zero (a flip at a near-zero gradient changes the
    next steps' gradients everywhere, so more elements move apart than
    after one step: they are counted)."""
    flow, vq = models[0], models[2]
    local = shard_batch(x, mesh)
    timing = time_step(mesh, copy.deepcopy(flow), vq, local, sizes)
    release(flow.device)
    twin_flow, plain_flow = copy.deepcopy(flow), copy.deepcopy(flow)
    step = ResidualStep(flow, vq, mesh, graphs=True)
    twin = ResidualStep(twin_flow, vq, mesh, graphs=False)
    plain = ResidualStep(plain_flow, vq, None, graphs=False)
    near = [torch.zeros_like(p, dtype=torch.bool)
            for p in plain_flow.parameters()]
    losses, plain_losses, first = [], [], None
    for i in range(steps):
        losses.append(float(step.graphed(local)))
        twin.graphed.eager(local)
        plain_losses.append(float(plain.graphed.eager(x)))
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in plain_flow.parameters()]
        gmax = max(float(g.abs().max()) for g in grads)
        near = [m | (g.abs() <= NEAR * gmax) for m, g in zip(near, grads)]
        if i == 0:
            first = against_plain(flow, plain_flow, near)
            mesh.check(first["beyond_1e-6_not_near_zero"] == 0
                       and first["max_abs_diff"] <= 2 * LR + 1e-6
                       and first["beyond_1e-6"] <= 0.01 * first["elements"],
                       f"one sharded step against the plain step: {first}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    mesh.check(loss_rel <= LOSS_RTOL,
               f"sharded losses {losses} against plain {plain_losses}")
    shas = mesh.all_gather_object(params_sha256(flow))
    mesh.check(len(set(shas)) == 1, f"params differ across ranks: {shas}")
    twin_equal = all(torch.equal(a, b) for a, b in zip(
        flow.state_dict().values(), twin_flow.state_dict().values()))
    mesh.check(twin_equal, "the captured step differs from its eager twin")
    last = against_plain(flow, plain_flow, near)
    mesh.check(last["beyond_1e-6_not_near_zero"]
               <= NOT_NEAR_SHARE * last["elements"],
               f"{steps} sharded steps against the plain steps: {last}")
    graphed = step.graphed
    return {
        "steps": steps, "losses": losses, "plain_losses": plain_losses,
        "loss_max_rel_diff": loss_rel,
        "local_batch": int(local.shape[0]), "global_batch": int(x.shape[0]),
        "captured": graphed.graphs, "captures": graphed.captures,
        "replays": graphed.replays, "capture_s": graphed.capture_seconds,
        **timing, "params_sha256": shas[0],
        "params_equal_across_ranks": True, "equal_to_eager_twin": True,
        "against_plain_first_step": first, "against_plain": last}


def vq_sets(rng, codebook: torch.Tensor, n: int, full: bool):
    """The query sets: `normal`, N(0, 1) queries (JAX's draw); at full
    size also `near`, each query near a codeword, and `tied`, queries near
    codewords 0.. of a codebook whose second `tile` shard starts with
    copies of them, so every query ties exactly across the shards."""
    cb = codebook.detach()
    K, dim = cb.shape
    sets = {"normal": (rng.normal(0, 1, (n, dim)).astype(np.float32), cb)}
    if full:
        pick = rng.integers(0, K, n)
        near = cb.cpu().numpy()[pick] + 0.1 * rng.normal(0, 1, (n, dim))
        tied_cb = cb.clone()
        m = min(256, K // 2)
        tied_cb[K // 2:K // 2 + m] = cb[:m]
        pick = rng.integers(0, m, n)
        tied = cb.cpu().numpy()[pick] + 0.1 * rng.normal(0, 1, (n, dim))
        sets["near"] = (near.astype(np.float32), cb)
        sets["tied"] = (tied.astype(np.float32), tied_cb)
    return sets


def vq_check(mesh, x, cb):
    """Part 2: the sharded lookup of x in cb over `tile` against the dense
    argmin on this rank -> (report, indices): indices, rows, and how far a
    differing pick lies beyond the dense one in float64 distance against
    the float32 rounding bound of the two lookups, 2 gamma_(D+2) (|x| +
    max |c|)^2 with gamma_n = n u / (1 - n u), u = 2^-24; the lookup
    timed after a warm-up."""
    x = torch.as_tensor(x).to(mesh.device)
    sharded_vq_lookup(x, cb, mesh, axis="tile")
    (vq_x, idx), s = fenced(lambda: sharded_vq_lookup(x, cb, mesh,
                                                      axis="tile"),
                            mesh.device)
    dense = ((x * x).sum(1, keepdim=True) + (cb * cb).sum(1)
             - 2.0 * (x @ cb.T)).argmin(1)

    def dist64(i):
        return ((x.double() - cb[i].double()) ** 2).sum(1)

    n, u = x.shape[1] + 2, 2.0 ** -24
    gamma = n * u / (1 - n * u)
    bound = 2 * gamma * (x.double().norm(dim=1)
                         + cb.double().norm(dim=1).max()) ** 2
    excess = dist64(idx) - dist64(dense)
    return {"queries": int(x.shape[0]), "codewords": int(cb.shape[0]),
            "dim": int(x.shape[1]),
            "indices_differ_dense": int((idx != dense).sum()),
            "indices_equal_dense": bool(torch.equal(idx, dense)),
            "rows_equal": bool(torch.equal(vq_x, cb[idx])),
            "max_excess_dist": float(excess.max()),
            "within_rounding": bool((excess <= bound).all()),
            "in_first_shard": bool((idx < cb.shape[0] // 2).all()),
            "lookup_s": s}, idx


def rans_check(mesh, z, means, lsc, streams: int) -> dict:
    """Part 3: chip-local sharded rANS, each rank's container against a
    single-process encode of its shard, the decode exact; one untimed
    round trip first (the kernels' first use)."""
    dev = mesh.device
    sharded_decode(sharded_encode(z, means, lsc, mesh, num_streams=streams),
                   means, lsc, mesh)
    blobs, enc_s, enc_l = counted(
        lambda: sharded_encode(z, means, lsc, mesh, num_streams=streams), dev)
    solo = encode_tensor(*(torch.from_numpy(shard_batch(a, mesh)).to(dev)
                           for a in (z, means, lsc)), streams)
    out, dec_s, dec_l = counted(
        lambda: sharded_decode(blobs, means, lsc, mesh), dev)
    mesh.check(blobs[mesh.rank] == solo,
               "a rank's rANS container differs from its solo encode")
    mesh.check(np.array_equal(out.cpu().numpy(), z),
               "the sharded rANS decode is not exact")
    n = z[0].size * (z.shape[0] // mesh.size)
    S = IL.pick_num_streams(n, streams)
    return {"containers": len(blobs), "bytes": sum(map(len, blobs)),
            "byte_identical_solo": True, "exact": True,
            "compress_s": enc_s, "decompress_s": dec_s,
            "launches": {"compress": enc_l, "decompress": dec_l},
            "kernel_shapes": [[S, IL._plan_steps(n, S), False]]}


def codec_check(mesh, compress, decompress, x):
    """Parts 4-5: a sharded codec's compress() and decompress(packed),
    warmed up twice (a fused codec's eager call, then its capture), then
    one counted and timed pass each way, the decode exact."""
    dev = mesh.device
    for _ in range(2):
        decompress(compress())
    packed, enc_s, enc_l = counted(compress, dev)
    rec, dec_s, dec_l = counted(lambda: decompress(packed), dev)
    mesh.check(np.array_equal(rec, x), "a sharded codec decode is not exact")
    return packed, {"compress_s": enc_s, "decompress_s": dec_s,
                    "launches": {"compress": enc_l, "decompress": dec_l},
                    "byte_identical_solo": True, "exact": True}


def kernels_against_plain(S: int, k: int, seeded: bool, seed: int, device):
    """The three kernels against their plain versions on one seeded [k, S]
    message (`bench.clamped_message`, the one chip_smoke.py's kernel rows
    check): the largest difference of each (0: bit for bit) and the
    decode's exactness.  On a CPU tensor the wrappers run the plain
    versions."""
    v, m, s, lower = clamped_message(S, k, seed, device)
    seeds = (torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 2 ** 32, S)).to(device) if seeded else None)
    pre = max_err([(cuda_rans.rans_cdf_prepass(v, m, s, lower),
                    IL.cdf_prepass_plain(v, m, s, lower))])
    enc = cuda_rans.rans_encode(v, m, s, lower, seeds)
    encode = max_err(zip(enc, IL.encode_plain(v, m, s, lower, seeds)))
    buf, total = IL.compact(enc[0], enc[1])
    dec = cuda_rans.rans_decode(buf, total, enc[2], enc[3], m, s, lower)
    decode = max_err(zip(dec, IL.decode_plain(buf, total, enc[2], enc[3], m,
                                              s, lower)))
    return {"S": S, "k": k, "seeded": seeded, "prepass_max_abs_err": pre,
            "encode_max_abs_err": encode, "decode_max_abs_err": decode,
            "decode_exact": bool(torch.equal(dec[0], v))}


def dryrun_multichip(n_devices: int, full: bool = False, steps: int = 3,
                     device=None, models=None) -> dict:
    """The dry run (module docstring) on this rank of an initialised group
    of `n_devices` ranks, on `device` (default: the current card); returns
    the report, the same on every rank but for `rank`.  `models`:
    (conditional flow, unconditional flow, VQ-VAE, VQ-VAE input size) in
    place of the seeded ones of the size (the CPU tests pass the JAX
    package's weights); the conditional flow is the one the sharded step
    trains."""
    t0 = time.time()
    sizes = SIZES["full" if full else "parity"]
    mesh = make_mesh(mesh_shape_for(n_devices), device=device)
    if mesh is None or mesh.size != n_devices:
        raise ValueError(f"{n_devices} devices: the group has "
                         f"{None if mesh is None else mesh.size} ranks")
    device = mesh.device
    if models is None:
        models = (full_models if full else parity_models)(device)
    flow, uflow, vq, input_size = models
    codec_flow = copy.deepcopy(flow)  # the codecs code the initial weights
    n, side = n_devices, sizes["side"]

    # the inputs, drawn in JAX's order
    rng = np.random.default_rng(0)
    x = grid(rng, (sizes["per_rank"] * n, side, side, 3))
    report = {"size": "full" if full else "parity",
              "config": CONFIG if full else "__graft_entry__.py:103-117",
              "reduced": REDUCED if full else [], "mesh": dict(mesh.shape),
              "backend": mesh.backend, "n_devices": n, "rank": mesh.rank}
    report["train"] = train_check(mesh, models, torch.from_numpy(x).to(
        device), steps, sizes)
    release(device)

    vqr = report["vq"] = {}
    for name, (q, cb) in vq_sets(rng, vq.vq.codebook, sizes["vq_queries"],
                                 full).items():
        vqr[name], idx = vq_check(mesh, q, cb)
        if not full:  # JAX's 16 indices, which the CPU tests compare
            vqr[name]["indices"] = idx.cpu().tolist()
    mesh.check(all(r["rows_equal"] and r["within_rounding"]
                   for r in vqr.values()),
               f"sharded VQ rows or distances off: {vqr}")
    mesh.check(all(vqr[k]["indices_equal_dense"] for k in vqr
                   if k != "normal" or not full),
               "sharded VQ indices differ from the dense argmin")
    mesh.check("tied" not in vqr or vqr["tied"]["in_first_shard"],
               "a cross-shard tie did not go to the lowest global index")

    per = sizes["rans_per_rank"]
    means = rng.uniform(-1, 1, (n, per)).astype(np.float32)
    lsc = np.full((n, per), -2.0, np.float32)
    sym = np.round((means + np.exp(lsc) * rng.logistic(0, 1, means.shape))
                   * 256).astype(np.int32)
    z = (np.clip(sym, -1024 + np.round(means * 256),
                 1023 + np.round(means * 256)).astype(np.float32) / 256.0)
    report["rans"] = rans_check(mesh, z, means, lsc, sizes["rans_streams"])

    ux = grid(rng, (sizes["codec_per_rank"] * n, sizes["codec_side"],
                    sizes["codec_side"], 3))
    fused = FlowCodec(uflow, num_streams=sizes["flow_streams"],
                      granularity="fused")
    level = FlowCodec(uflow, num_streams=sizes["flow_streams"],
                      granularity="level")
    sflow = ShardedFlowCodec(fused, mesh)
    (blobs, info), rep = codec_check(
        mesh, lambda: sflow.compress(ux),
        lambda p: sflow.decompress(*p, fetch=True), ux)
    mine = blobs[mesh.rank * uflow.cfg.nsplit:
                 (mesh.rank + 1) * uflow.cfg.nsplit]
    mesh.check(mine == level.compress(torch.from_numpy(shard_batch(
        ux, mesh)).to(device))[0],
        "a rank's flow containers differ from its solo level encode")
    local = int(ux.shape[0]) // n
    report["flow_codec"] = {**rep, "granularity": fused.granularity,
                            "containers": len(blobs),
                            "bytes": sum(map(len, blobs)),
                            "real_bpd": sflow.real_bpd(blobs, info),
                            "kernel_shapes": coded_shapes(fused, [local])}
    del sflow, fused, level

    res_fused = ResidualCodec(vq, FlowCodec(
        codec_flow, num_streams=sizes["flow_streams"], granularity="fused"),
        input_size)
    res_level = ResidualCodec(vq, FlowCodec(
        codec_flow, num_streams=sizes["flow_streams"], granularity="level"),
        input_size)
    sres = ShardedResidualCodec(res_fused, mesh)
    (idx_blobs, rblobs, rinfo), rep = codec_check(
        mesh, lambda: sres.compress(x),
        lambda p: sres.decompress(*p, fetch=True), x)
    nsplit = codec_flow.cfg.nsplit
    solo_idx, solo_blobs, _ = res_level.compress(
        torch.from_numpy(shard_batch(x, mesh)).to(device))
    mesh.check(idx_blobs[mesh.rank] == solo_idx and rblobs[
        mesh.rank * nsplit:(mesh.rank + 1) * nsplit] == solo_blobs,
        "a rank's residual containers differ from its solo level encode")
    patches = sizes["per_rank"] * (side // codec_flow.cfg.H) * (
        side // codec_flow.cfg.W)
    report["residual_codec"] = {
        **rep, "index_streams": len(idx_blobs), "containers": len(rblobs),
        "bytes": sres.coded_bits(idx_blobs, rblobs) // 8,
        "real_bpd": sres.real_bpd(idx_blobs, rblobs, rinfo),
        "kernel_shapes": coded_shapes(res_fused.codec, [patches])}
    del sres, res_fused, res_level

    # every launch shape against the plain versions
    shapes = sorted({tuple(s) for part in ("rans", "flow_codec",
                                           "residual_codec")
                     for s in report[part]["kernel_shapes"]})
    rows = [kernels_against_plain(S, k, seeded, 300 + i, device)
            for i, (S, k, seeded) in enumerate(shapes)]
    mesh.check(all(r["decode_exact"] and not (
        r["prepass_max_abs_err"] or r["encode_max_abs_err"]
        or r["decode_max_abs_err"]) for r in rows),
        f"a kernel differs from its plain version: {rows}")
    report["kernels_against_plain"] = rows
    report["launches_per_rank"] = mesh.all_gather_object(
        {part: report[part]["launches"] for part in
         ("rans", "flow_codec", "residual_codec")})
    report["cards"] = mesh.all_gather_object(device_label(device))
    report["wall_s"] = time.time() - t0
    return report


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4,
                    help="ranks to spawn when not launched by torchrun")
    ap.add_argument("--full", action="store_true",
                    help="the widths of " + CONFIG)
    ap.add_argument("--steps", type=int, default=3,
                    help="checked train steps (the first eager, the second "
                    "captured, then replays)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU (default: a card "
                    "each, NCCL)")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=None,
                    help="write the JSON here too (a new file)")
    return ap


def run_rank(args, build=None) -> dict:
    """One rank: join the group, run the dry run (its models from
    `build(device)` where given), rank 0 prints the report as one JSON
    line and writes it to --out.  Returns the report."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, shutdown

    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // int(os.environ["WORLD_SIZE"])))
    device = init_distributed(device=args.device, timeout_s=args.timeout)
    t0 = time.time()
    fn, example = entry(device)
    with torch.no_grad():
        entry_loss = float(fn(*example))
    report = dryrun_multichip(
        dist.get_world_size(), args.full, args.steps, device,
        None if build is None else build(device))
    report = {"entry_loss": entry_loss, **report,
              "rank_wall_s": time.time() - t0}
    if report["rank"] == 0:
        print(json.dumps(report), flush=True)
        if args.out:
            write_new(args.out, report)
    shutdown()
    return report


def main(argv=None):
    args = _parser().parse_args(argv)
    if "RANK" in os.environ:
        return run_rank(args)
    check_cards(args.nproc, args.device)
    spawn_ranks(run_rank, args.nproc, (args,), timeout_s=args.timeout)
    return None


if __name__ == "__main__":
    main()
