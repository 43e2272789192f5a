"""Host milliseconds of a traced round trip spent on the two-level
pyramid's own work: the program spans `twolevel.split` (a batch's pad,
pool, grid rounding, unpool and tiling before the sub-flows code it) and
`twolevel.merge` (a decoded batch's unpool, tile merge and crop), per
round trip.  Layer: two-level pyramid (models/twolevel_codec.py,
models/twolevel.py)."""

from lic_bench.spans import span_ms

MOVES = "roundtrip_images_per_s"


def read(r):
    return span_ms(r, ("twolevel.split", "twolevel.merge"))
