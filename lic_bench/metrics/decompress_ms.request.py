"""Median host milliseconds of one request's
`ResidualCodec.decompress_many(fetch=True)` call (indices unpacked, the
reconstruction, the flow's graph replay, the image fetched and checked)
over the measured window: the harness's span around the call.  Layer:
residual serving API (models/residual_codec.py)."""

from lic_bench.reduce import median_ms

MOVES = "request_p95_ms"


def read(r):
    spans = r.spans.get("decompress")
    return median_ms(spans) if spans else None
