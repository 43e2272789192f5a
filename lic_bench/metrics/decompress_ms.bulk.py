"""Median host milliseconds of one `FlowCodec.decompress_many(fetch=True)`
call (a queue, images fetched and state invariants checked) over the
measured window: the harness's span around the call.  Layer: serving API
(models/exact.py)."""

from lic_bench.reduce import median_ms

MOVES = "roundtrip_images_per_s"


def read(r):
    spans = r.spans.get("decompress")
    return median_ms(spans) if spans else None
