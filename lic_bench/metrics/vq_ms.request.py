"""Host milliseconds of a traced request spent in the eager VQ-VAE: the
program spans `residual.vq_encode` (the encoder and the codebook search)
and `residual.reconstruct` (the decoder on the codewords, once a
direction) over the traced window, per request.  Layer: eager VQ-VAE
(models/residual_codec.py, models/vqvae.py)."""

from lic_bench.spans import span_ms

MOVES = "request_p95_ms"


def read(r):
    return span_ms(r, ("residual.vq_encode", "residual.reconstruct"))
