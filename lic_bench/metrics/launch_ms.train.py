"""Host milliseconds of a traced train call spent in the K-step graph's
replay: the program spans `step.replay` (the `replay()` call, one a call)
over the traced window, per call.  Layer: graph replay (utils/graphs.py,
`GraphedStep`)."""

from lic_bench.spans import span_ms

MOVES = "train_images_per_s"


def read(r):
    return span_ms(r, ("step.replay",))
