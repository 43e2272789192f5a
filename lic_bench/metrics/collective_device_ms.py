"""Device milliseconds of the NCCL kernels a train step runs on rank 0,
from its profile of the traced calls: the gradient all_reduce's transfer
and its wait for the slowest rank.  Layer: scale-out (parallel/mesh.py,
parallel/sharding.py)."""

MOVES = "train_images_per_s"


def read(r):
    if r.extra.get("ranks", 1) < 2:
        return None
    secs = r.trace.kernel_seconds(lambda n: "nccl" in n.lower())
    if secs <= 0:
        return None
    return 1e3 * secs / (r.passes * r.extra["steps"])
