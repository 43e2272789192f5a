"""Median host milliseconds of one `FlowCodec.compress_many` call (a
queue, containers packed to the host) over the measured window: the
harness's span around the call.  Layer: serving API (models/exact.py)."""

from lic_bench.reduce import median_ms

MOVES = "roundtrip_images_per_s"


def read(r):
    return median_ms(r.spans["compress"]) if r.spans.get("compress") else None
