"""Host milliseconds of a traced request spent in the conditional flow's
graph replays: the program spans `codec.replay` (one a direction, two a
request) over the traced window, per request.  Layer: graph replay
(models/exact.py, `FlowCodec._fused`)."""

from lic_bench.spans import span_ms

MOVES = "request_p95_ms"


def read(r):
    return span_ms(r, ("codec.replay",))
