"""Multi-process runtime: real torch.distributed execution.

N OS processes, a localhost rendezvous from the torchrun variables, a
mesh over every rank (on the card by default: NCCL with one card per
rank, or gloo where the caller asks for it, e.g. ranks sharing one card;
`device="cpu"` runs gloo on the CPU), the sharded data loader
partitioning each epoch by rank, and a sharded train step whose results
are checked IDENTICAL on every rank.  Then every rank compresses its own
image shard with the trained parameters, and a separately spawned
single-process coder reproduces every rank's containers.

Entry points:
- worker_main(): what each spawned rank runs (`python -m
  finalproject_losslessimagecompression_tpu_torch.parallel.multiproc`,
  with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set).
- reference_main(): the single-process reference coder (`--reference`).
- launch(num_processes, ..., device, backend): spawns the ranks and the
  reference, checks their reports against each other (identical final
  parameters and loss series, disjoint epoch coverage, containers
  reproduced byte for byte) and returns the summary (the JAX package's
  keys).  `launch_main()` is its command line (`--launch N`, with
  `--device cuda:0 --backend gloo` for ranks sharing one card, or
  `--device cpu`).
- spawn_ranks(fn, nprocs, args, timeout_s): runs fn on nprocs spawned
  ranks of one machine, each with the torchrun variables set.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import List

PACKAGE = "finalproject_losslessimagecompression_tpu_torch"
# train steps a rank takes at least: the eager first, the capturing second
# and one or more whose collective time is measured
MIN_STEPS = 3


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def torchrun_env(rank: int, world: int, port: int) -> dict:
    """The variables torchrun sets for `rank` of a one-machine group."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def check_cards(nprocs: int, device=None, backend: str | None = None) -> None:
    """Raise, before anything is spawned, where `nprocs` ranks on `device`
    cannot run: no card where one is asked for (the default), or fewer
    cards than ranks where each rank takes a card of its own (the default
    device under NCCL; `backend="gloo"` lets ranks share the cards)."""
    import torch

    from ..models.idflow import resolve_device

    if resolve_device(device).type != "cuda" or device is not None \
            or backend == "gloo":
        return
    if torch.cuda.device_count() < nprocs:
        raise RuntimeError(
            f"{nprocs} ranks need a card each, {torch.cuda.device_count()} "
            "visible; NCCL refuses two ranks on one card (ask for "
            "backend='gloo' to share them)")


def _rank_entry(i: int, fn, world: int, port: int, args) -> None:
    os.environ.update(torchrun_env(i, world, port))
    fn(*args)


def spawn_ranks(fn, nprocs: int, args=(), timeout_s: float = 600.0) -> None:
    """Run fn(*args) in nprocs spawned processes, ranks 0..nprocs-1 of one
    machine with the torchrun variables set; a rank that fails raises
    here, and ranks still running after timeout_s are killed and raise."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_entry, (fn, nprocs, free_port(), args),
                             nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.time() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.time())):
            if time.time() >= deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


def _coding_shard(pid: int, batch: int):
    """Rank `pid`'s deterministic image shard for the coding phase (the
    reference coder regenerates the identical arrays by pid)."""
    import numpy as np

    crng = np.random.default_rng(1000 + pid)
    return (
        np.round(crng.uniform(0, 1, (batch, 8, 8, 3)) * 256)
        .astype(np.float32) / 256.0
    )


def _worker_flow_cfg():
    from ..models.config import CouplingCfg, DenseBlockCfg, FlowCfg

    return FlowCfg(
        H=8, W=8, C=3, nflows=1, nsplit=1,
        couple=CouplingCfg(0.75, DenseBlockCfg(8, 1, "LeakyReLU")),
        prior_nn=DenseBlockCfg(8, 1, "LeakyReLU"),
    )


def _compress_report(codec, x):
    """Chip-local compress + decode-verify of one shard -> report dict
    (the container digest is over every container in order)."""
    import numpy as np

    blobs, info = codec.compress(x)
    rec = codec.decompress(blobs, info, fetch=True)
    h = hashlib.sha256()
    for b in blobs:
        h.update(b)
    return {
        "container_sha256": h.hexdigest(),
        "bit_exact": bool(np.array_equal(rec, x)),
        "real_bpd": round(codec.real_bpd(blobs, info), 4),
        "nbytes": int(sum(len(b) for b in blobs)),
    }


def params_sha256(model) -> str:
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def worker_main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--coding-batch", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--params-out", type=str, default="",
                    help="rank 0: save the trained params here (the "
                    "reference coder codes against them)")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the card of index LOCAL_RANK")
    ap.add_argument("--backend", type=str, default=None,
                    help="default: nccl on a card, gloo on the CPU")
    args = ap.parse_args(argv)
    if args.steps < MIN_STEPS:
        ap.error(f"--steps {args.steps}: at least {MIN_STEPS}")

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..data.loader import DataLoader
    from ..models.exact import FlowCodec
    from ..models.idflow import IDFlow
    from ..train.optim import build_optimizer
    from ..utils.profiling import collective_ms
    from .mesh import init_distributed, make_mesh, shutdown
    from .sharding import make_sharded_train_step

    torch.set_num_threads(1)
    device = init_distributed(backend=args.backend, device=args.device,
                              timeout_s=args.timeout)
    pid, n = dist.get_rank(), dist.get_world_size()

    # index-stamped dataset: sample j is the constant image j/256, so the
    # batches a rank actually TRAINS ON reveal its epoch coverage
    n_samples = 8 * args.local_batch * n

    class Stamped:
        def __len__(self):
            return n_samples

        def __getitem__(self, j):
            return np.full((8, 8, 3), j / 256.0, np.float32)

    # the sharded loader: every rank draws the same seeded permutation and
    # takes its disjoint stride -- `shard: true` in configs resolves to
    # exactly these coordinates
    loader = DataLoader(Stamped(), args.local_batch, shuffle=True,
                        train=True, seed=3, shard_index=pid, shard_count=n)
    model = IDFlow(_worker_flow_cfg(), device=device, seed=0)
    opt = build_optimizer(model.parameters(), {"name": "Adam", "lr": 1e-3},
                          None, 1)
    mesh = make_mesh(device=device)
    step = make_sharded_train_step(model, opt, mesh)

    losses, covered = [], set()

    def train(steps):
        for _ in range(steps):
            local = next(loader)
            covered.update(int(v)
                           for v in np.round(local[:, 0, 0, 0] * 256.0))
            # each rank trains on its local shard of the global batch; the
            # step all_reduces the gradients over the whole mesh
            losses.append(float(step.local(local)))

    # collective time per step over the steps after the eager first and
    # the capturing second: the NCCL kernels' device time under NCCL, the
    # mesh's host seconds under gloo
    train(2)
    collective = collective_ms(mesh, lambda: train(args.steps - 2),
                               args.steps - 2)

    # coding phase: each rank compresses its own image shard with the
    # trained params, chip-locally; the reference coder codes the same
    # shards in one plain process and must reproduce every container
    codec = FlowCodec(model.eval(), num_streams=64)
    coding = _compress_report(codec, _coding_shard(pid, args.coding_batch))
    if pid == 0 and args.params_out:
        torch.save(model.state_dict(), args.params_out)

    report = {
        "coding": coding,
        "process_id": pid,
        "num_processes": n,
        "device": str(device),
        "backend": mesh.backend,
        "local_devices": 1,
        "global_devices": mesh.size,
        "mesh_shape": dict(mesh.shape),
        "losses": losses,
        "params_sha256": params_sha256(model),
        "covered_indices": sorted(covered),
        "n_samples": n_samples,
        "collective_calls": mesh.comm_calls,
        "collective_steps": args.steps - 2,
        **collective,
    }
    with open(args.out, "w") as f:
        json.dump(report, f)
    del train, step  # the captured step's graph goes before the group
    shutdown()


def reference_main(argv: List[str] | None = None) -> None:
    """Single-process reference coder: loads the params rank 0 saved,
    compresses EVERY rank's coding shard in one ordinary process (no
    process group), and reports per-shard container digests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", type=str, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coding-batch", type=int, default=4)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the card")
    args = ap.parse_args(argv)

    import torch

    from ..models.exact import FlowCodec
    from ..models.idflow import IDFlow, resolve_device

    torch.set_num_threads(1)
    device = resolve_device(args.device)
    model = IDFlow(_worker_flow_cfg(), device=device, seed=0)
    model.load_state_dict(torch.load(args.params, map_location=device,
                                     weights_only=True))
    codec = FlowCodec(model.eval(), num_streams=64)
    shards = [_compress_report(codec, _coding_shard(pid, args.coding_batch))
              for pid in range(args.num_processes)]
    with open(args.out, "w") as f:
        json.dump({"shards": shards}, f)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def _run_all(cmds, envs, timeout_s: float) -> None:
    """Start every command, wait for all within timeout_s (killing the rest
    on a failure or a timeout); raises with the failing command's log."""
    procs = [subprocess.Popen(c, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for c, e in zip(cmds, envs)]
    deadline = time.time() + timeout_s
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            if p.returncode != 0:
                raise RuntimeError(f"{p.args[3:]} rc={p.returncode}:\n"
                                   + out.decode(errors="replace")[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def launch(num_processes: int = 2, steps: int = 8, local_batch: int = 4,
           timeout_s: float = 600.0, device=None,
           backend: str | None = None) -> dict:
    """Spawn the ranks, cross-check their reports, return the summary.

    The ranks and the reference coder run on `device`: by default the
    card of index LOCAL_RANK for each rank (NCCL, one card per rank; it
    raises where there are fewer cards than ranks), a named card shared by
    every rank with backend="gloo", or the CPU with device="cpu" (gloo).
    Each rank takes `steps` >= MIN_STEPS train steps."""
    if steps < MIN_STEPS:
        raise ValueError(f"steps={steps}: at least {MIN_STEPS}")
    check_cards(num_processes, device, backend)  # before spawning
    tmp = tempfile.mkdtemp(prefix="lic_multiproc_")
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    module = [sys.executable, "-m", f"{PACKAGE}.parallel.multiproc"]
    t0 = time.time()
    try:
        return _launch(module, env, tmp, num_processes, steps, local_batch,
                       timeout_s, t0, device, backend)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _launch(module, env, tmp, num_processes, steps, local_batch, timeout_s,
            t0, device, backend) -> dict:
    port = free_port()
    where = [] if device is None else ["--device", str(device)]
    outs = [os.path.join(tmp, f"rank{i}.json") for i in range(num_processes)]
    params_path = os.path.join(tmp, "params.pt")
    _run_all(
        [module + ["--out", outs[i], "--steps", str(steps),
                   "--local-batch", str(local_batch),
                   "--timeout", str(timeout_s),
                   "--params-out", params_path] + where
         + ([] if backend is None else ["--backend", backend])
         for i in range(num_processes)],
        [dict(env, **torchrun_env(i, num_processes, port))
         for i in range(num_processes)], timeout_s)
    reports = []
    for o in outs:
        with open(o) as f:
            reports.append(json.load(f))

    # -- cross-rank checks ---------------------------------------------
    shas = {r["params_sha256"] for r in reports}
    if len(shas) != 1:
        raise AssertionError(f"params diverged across ranks: {shas}")
    if len({tuple(r["losses"]) for r in reports}) != 1:
        raise AssertionError("replicated losses differ across ranks")
    cov = [set(r["covered_indices"]) for r in reports]
    for i in range(len(cov)):
        for j in range(i + 1, len(cov)):
            if cov[i] & cov[j]:
                raise AssertionError(
                    f"ranks {i},{j} shared samples: {cov[i] & cov[j]}")
    seen_per_rank = reports[0]["n_samples"] // num_processes
    # `steps` local batches per rank cover min(steps*local_batch, shard)
    expect = min(steps * local_batch, seen_per_rank)
    if any(len(c) != expect for c in cov):
        raise AssertionError(f"coverage {[len(c) for c in cov]} != {expect}")
    if not all(r["coding"]["bit_exact"] for r in reports):
        raise AssertionError("a rank's decode is not bit-exact")

    # -- coding cross-check: the single-process reference coder on rank
    # 0's saved params must reproduce every rank's containers
    ref_out = os.path.join(tmp, "reference.json")
    _run_all([module + ["--reference", "--params", params_path,
                        "--num-processes", str(num_processes),
                        "--out", ref_out] + where], [env], timeout_s)
    with open(ref_out) as f:
        ref_shards = json.load(f)["shards"]
    rank_digests = [r["coding"]["container_sha256"] for r in reports]
    ref_digests = [s["container_sha256"] for s in ref_shards]
    if rank_digests != ref_digests:
        raise AssertionError(
            f"containers diverged across processes: ranks={rank_digests} "
            f"reference={ref_digests}")

    return {
        "coding": {
            "byte_identical": True,
            "per_rank_container_sha256": rank_digests,
            "per_rank_real_bpd": [r["coding"]["real_bpd"] for r in reports],
            "bit_exact": True,
            "note": "each rank compressed its image shard chip-locally "
                    "with the trained params; a separately spawned "
                    "single-process coder reproduced every container "
                    "byte-identically",
        },
        "ok": True,
        "num_processes": num_processes,
        "global_devices": reports[0]["global_devices"],
        "local_devices": reports[0]["local_devices"],
        "mesh_shape": reports[0]["mesh_shape"],
        "steps": steps,
        "identical_params_sha256": reports[0]["params_sha256"],
        "identical_loss_series": reports[0]["losses"],
        "epoch_coverage": {
            "per_rank_samples": [len(c) for c in cov],
            "disjoint": True,
            "union_size": len(set().union(*cov)),
        },
        "wall_s": round(time.time() - t0, 2),
        "collective_time": [{k: v for k, v in r.items()
                             if k.startswith("collective_")}
                            for r in reports],
        "collectives": f"{reports[0]['backend']} on "
                       f"{[r['device'] for r in reports]}, one process per "
                       "rank (parallel.mesh.init_distributed from the "
                       "torchrun variables)",
    }


def launch_main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", type=int, nargs="?", const=2, default=2,
                    metavar="N", help="number of ranks (default 2)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: one card per rank; cuda:0 with "
                    "--backend gloo shares one card; cpu runs on the CPU")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cards, gloo on the CPU")
    a = ap.parse_args(argv)
    print(json.dumps(launch(a.launch, a.steps, a.local_batch, a.timeout,
                            a.device, a.backend), indent=1))


if __name__ == "__main__":
    if "--launch" in sys.argv:
        launch_main()
    elif "--reference" in sys.argv:
        reference_main([a for a in sys.argv[1:] if a != "--reference"])
    else:
        worker_main()
