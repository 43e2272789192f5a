"""The whole request's share of the card's float32 peak: the nominal
FLOPs of every request in the measured window (the conditional flow's
forward convs in both directions, the VQ-VAE's encoder once and decoder
twice, and the codebook search's distance product) over (the seconds the
requests were served, the sum of their spans, x 67 TFLOP/s).  Layer:
model step, whole request."""

from lic_bench.reduce import F32_PEAK_FLOPS

MOVES = "request_p95_ms"


def read(r):
    served = sum(r.spans.get("request", []))
    if not r.flops_per_pass or served <= 0:
        return None
    return 100.0 * r.flops_per_pass * len(r.spans["request"]) / (
        served * F32_PEAK_FLOPS)
