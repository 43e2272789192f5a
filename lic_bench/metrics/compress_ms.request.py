"""Median host milliseconds of one request's `ResidualCodec.compress_many`
call (VQ encode, reconstruction, the flow's graph replay, index stream and
containers packed to the host) over the measured window: the harness's
span around the call.  Layer: residual serving API
(models/residual_codec.py)."""

from lic_bench.reduce import median_ms

MOVES = "request_p95_ms"


def read(r):
    return median_ms(r.spans["compress"]) if r.spans.get("compress") else None
