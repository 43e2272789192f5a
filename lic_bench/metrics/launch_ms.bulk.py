"""Host milliseconds of a traced round trip spent in the fused codec's
graph replays: the program spans `codec.replay` (each `replay()` call of
a captured direction, two a round trip) over the traced window, per
round trip.  Layer: graph replay (models/exact.py, `FlowCodec._fused`)."""

from lic_bench.spans import span_ms

MOVES = "roundtrip_images_per_s"


def read(r):
    return span_ms(r, ("codec.replay",))
