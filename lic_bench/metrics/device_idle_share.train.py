"""Share of the traced train calls' wall in which no operation ran on the
device: 1 - (union of the device operations' intervals) / the traced
window.  Layer: device (H100)."""

MOVES = "train_images_per_s"


def read(r):
    if r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
