"""The train step's share of the float32 peak: the nominal conv FLOPs of
every step in the measured window (forward and backward of the published
DenseBlocks, fusion off: `reduce.flow_flops`) over (the window's seconds x
67 TFLOP/s x the cards).  Layer: model step (train/trainer.py,
utils/graphs.py, train/optim.py)."""

from lic_bench.reduce import F32_PEAK_FLOPS

MOVES = "train_images_per_s"


def read(r):
    if not r.flops_per_pass or r.window_s <= 0:
        return None
    cards = r.extra.get("ranks", 1)
    return 100.0 * r.flops_per_pass * r.windows / (
        r.window_s * F32_PEAK_FLOPS * cards)
