"""Host milliseconds of a traced round trip spent coding containers on
the host: the self time of the program spans `codec.pack` (serialising
the fetched streams), `codec.unpack` (parsing, validating and padding
them) and `codec.fetch` (splitting the decoded batches), less their
`codec.sync` children (the host waiting on the card's copy), per round
trip.  Layer: host container coding (codec/container.py,
models/exact.py)."""

from lic_bench.spans import span_ms

MOVES = "roundtrip_images_per_s"


def read(r):
    return span_ms(r, ("codec.pack", "codec.unpack", "codec.fetch"),
                   less=("codec.sync",))
