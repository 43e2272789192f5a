"""Host milliseconds of a traced request spent on the VQ index stream:
the self time of the program spans `residual.index_pack` (bit-packing the
fetched indices) and `residual.index_unpack` (unpacking them and their
upload), less their `codec.sync` children (the host waiting on the
indices' copy), per request.  Layer: index stream
(models/residual_codec.py)."""

from lic_bench.spans import span_ms

MOVES = "request_p95_ms"


def read(r):
    return span_ms(r, ("residual.index_pack", "residual.index_unpack"),
                   less=("codec.sync",))
