"""The whole round trip's share of the card's float32 peak: the nominal
forward conv FLOPs of both directions of every round trip in the measured
window over (the window's seconds x 67 TFLOP/s).  Layer: model step,
whole pass."""

from lic_bench.reduce import F32_PEAK_FLOPS

MOVES = "roundtrip_images_per_s"


def read(r):
    if not r.flops_per_pass or r.window_s <= 0:
        return None
    return 100.0 * r.flops_per_pass * r.windows / (r.window_s * F32_PEAK_FLOPS)
