"""Share of the float32 roofline the flow NNs' convolutions reach: the
nominal conv FLOPs of the traced round trips (the published DenseBlocks,
1x1 then 3x3 then the projection, forward in both directions, whatever
implements them) over 67 TFLOP/s, divided by the device seconds of the
convolution kernels in the trace.  Layer: flow NNs on cuDNN
(models/layers.py, models/idflow.py)."""

from lic_bench.reduce import F32_PEAK_FLOPS

MOVES = "roundtrip_images_per_s"
# names (substrings) of the kernels cuDNN runs for a float32 convolution on
# an H100 (seen in its traces): implicit-GEMM fprop / dgrad / wgrad, its
# own engines, and the FFT algorithm's transforms with their complex
# GEMMs (cuBLAS `cf32`); a real-valued cuBLAS GEMM (the fused layers'
# weight composition) is not a convolution
CONV_KERNELS = ("conv", "implicit_gemm", "implicit_convolve", "winograd",
                "fft", "fprop", "dgrad", "wgrad", "cudnn", "gemm_cf32")


def is_conv(name: str) -> bool:
    return any(k in name.lower() for k in CONV_KERNELS)


def read(r):
    secs = r.trace.kernel_seconds(is_conv)
    if secs <= 0 or not r.flops_per_pass:
        return None
    return 100.0 * r.flops_per_pass * r.passes / F32_PEAK_FLOPS / secs
