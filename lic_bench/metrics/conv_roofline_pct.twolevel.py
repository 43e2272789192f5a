"""Share of the float32 roofline the DenseLayer kernel reaches on the
FLOPs it actually does: 2 M g 9 cin per layer (`dense_flops`), over every
DenseBlock of both sub-flows of the two-level codec in both directions of
the traced round trips, at 67 TFLOP/s, divided by the device seconds of
the kernels whose names hold `dense_conv3x3` (the fprop and its split-K
reduce).  Layer: flow NNs (models/layers.py `DenseBlock.grow_in_place`,
ops/dense_conv.py, csrc/dense_conv.cu)."""

from lic_bench.reduce import F32_PEAK_FLOPS

MOVES = "roundtrip_images_per_s"


def read(r):
    flops = r.extra.get("dense_flops_per_pass")
    secs = r.trace.kernel_seconds(lambda n: "dense_conv3x3" in n)
    if secs <= 0 or not flops:
        return None
    return 100.0 * flops * r.passes / F32_PEAK_FLOPS / secs
