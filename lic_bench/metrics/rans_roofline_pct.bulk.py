"""Share of the HBM roofline the three rANS kernels reach: the bytes they
must move for the traced round trips (counted at the data's widths from
each container's launch shape and word count, `reduce.rans_bytes`) over
3.35 TB/s, divided by their device seconds in the trace.  Layer: rANS
kernels (codec/cuda_rans.py, csrc/rans_kernels.cu)."""

from lic_bench.reduce import HBM_BYTES_PER_S, RANS_KERNELS

MOVES = "roundtrip_images_per_s"


def read(r):
    secs = r.trace.kernel_seconds(lambda n: any(k in n for k in RANS_KERNELS))
    if secs <= 0 or not r.rans_bytes_per_pass:
        return None
    return 100.0 * r.rans_bytes_per_pass * r.passes / HBM_BYTES_PER_S / secs
