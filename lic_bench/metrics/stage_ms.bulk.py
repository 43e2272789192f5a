"""Host milliseconds of a traced round trip spent staging inputs on the
card: the program spans `codec.stage` (the images' upload, the pinning
and copy of the static inputs, the padded containers' upload) over the
traced window, per round trip.  Layer: host staging (models/exact.py)."""

from lic_bench.spans import span_ms

MOVES = "roundtrip_images_per_s"


def read(r):
    return span_ms(r, ("codec.stage",))
