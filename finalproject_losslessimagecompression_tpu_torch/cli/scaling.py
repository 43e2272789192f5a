"""Scaling-efficiency report: sharded-train-step throughput over growing
sub-meshes of ranks, written as a JSON artifact.

Usage:
  python -m finalproject_losslessimagecompression_tpu_torch.cli.scaling \\
      [--out SCALING.json] [--nproc 2] [--backend gloo] [--device cpu] \\
      [--growth 32] [--depth 2] [--batch 2]

Without the torchrun variables it spawns --nproc ranks on this machine
(one card each, NCCL; `--backend gloo` lets ranks share the cards, as on
a one-card machine; `--device cpu` runs gloo ranks on the CPU); under
torchrun (`torchrun --nproc_per_node N -m ...cli.scaling`) each process
is one rank.  Rank 0 writes the artifact.

Where ranks share a card or cores the honest metric is `overhead` mode
(fixed total compute: the cost of sharding and of the collectives); with
a card per rank, `weak` mode measures the north star (>=85% efficiency
1 -> N).  Both are recorded, and `weak_scaling_on_hardware` says which
the run could show: measured, naming the cards (nvidia-smi's name and
power limit of each) and the backend, where every rank had a card of its
own and there were at least two; unmeasured otherwise.  With fewer cards
than ranks and no `--backend gloo` it raises before spawning.
"""

from __future__ import annotations

import argparse
import json
import os


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="SCALING.json")
    ap.add_argument("--nproc", type=int, default=2,
                    help="ranks to spawn when not launched by torchrun")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cards, gloo on the CPU; gloo "
                    "lets ranks share a card")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--growth", type=int, default=32)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--nflows", type=int, default=4)
    ap.add_argument("--nsplit", type=int, default=2)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2, help="per-device batch")
    ap.add_argument("--steps", type=int, default=10)
    return ap


def _rank_device(args):
    """This rank's device: the CPU, its own card, or under gloo a card
    shared round robin."""
    if args.device is not None:
        return args.device
    import torch

    local = int(os.environ["LOCAL_RANK"])
    if args.backend == "gloo":
        return f"cuda:{local % torch.cuda.device_count()}"
    return None


def weak_scaling_stamp(cards, backend: str) -> str:
    """`weak_scaling_on_hardware` for ranks on `cards`: each rank's (card
    id, nvidia-smi's name and power limit of it), or None for a rank on
    the CPU."""
    ids = [c[0] for c in cards if c is not None]
    if len(set(ids)) < 2 or len(set(ids)) != len(cards):
        return ("unmeasured (fewer than two cards of their own; the `weak` "
                "numbers below share a card or the CPU and must NOT be read "
                "against the >=85% north star)")
    return (f"measured on {len(ids)} cards of their own ("
            + "; ".join(label for _, label in cards)
            + f"), backend {backend}")


def run_rank(args) -> None:
    """One rank's part: join the group, measure, rank 0 writes."""
    import torch

    from ..models import CouplingCfg, DenseBlockCfg, FlowCfg, IDFlow
    from ..parallel.mesh import init_distributed, make_mesh, shutdown
    from ..parallel.scaling import measure_scaling
    from ..utils.profiling import device_label

    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["WORLD_SIZE"])))
    device = init_distributed(args.backend, _rank_device(args),
                              timeout_s=args.timeout)
    nn = DenseBlockCfg(args.growth, args.depth, "ReLU")
    cfg = FlowCfg(H=args.size, W=args.size, C=3, nflows=args.nflows,
                  nsplit=args.nsplit, couple=CouplingCfg(0.75, nn),
                  prior_nn=nn)
    model = IDFlow(cfg, device=device, seed=0)
    everyone = make_mesh(device=device)
    cards = everyone.all_gather_object(
        (str(torch.cuda.get_device_properties(device).uuid),
         device_label(device)) if device.type == "cuda" else None)
    out = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "backend": everyone.backend,
        "n_devices": everyone.size,
        "distinct_cards": len({c[0] for c in cards if c is not None}),
        "cards": [None if c is None else c[1] for c in cards],
        "physical_cores": os.cpu_count(),
        "model": {"H": args.size, "W": args.size, "nflows": args.nflows,
                  "nsplit": args.nsplit, "growth": args.growth,
                  "depth": args.depth},
        "per_device_batch": args.batch,
        "note": (
            "overhead mode: fixed global batch, efficiency isolates "
            "sharding + collective cost (1.0 = free); weak mode: fixed "
            "per-device batch, the north star where every rank has a card "
            "of its own -- with ranks sharing a card or cores it is capped "
            "by the shared hardware and reported for completeness only."
        ),
    }
    out["weak_scaling_on_hardware"] = weak_scaling_stamp(cards,
                                                         everyone.backend)
    for mode in ("overhead", "weak"):
        res = measure_scaling(model, per_device_batch=args.batch,
                              steps=args.steps, mode=mode)
        out[mode] = {str(nd): r for nd, r in res.items()}
    if everyone.rank == 0:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    shutdown()


def main(argv=None):
    args = _parser().parse_args(argv)
    if "RANK" in os.environ:
        run_rank(args)
        return None
    from ..parallel.multiproc import check_cards, spawn_ranks

    check_cards(args.nproc, args.device, args.backend)
    spawn_ranks(run_rank, args.nproc, (args,), timeout_s=args.timeout)
    with open(args.out) as f:
        out = json.load(f)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
