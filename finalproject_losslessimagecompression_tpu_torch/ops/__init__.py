"""Grid rounding, layout transforms and the discretized logistic."""

from .dlogistic import dlogistic_log_prob
from .reshape import depth_to_space, space_to_depth
from .rounding import round_ste, round_to_grid

__all__ = [
    "dlogistic_log_prob",
    "depth_to_space",
    "space_to_depth",
    "round_ste",
    "round_to_grid",
]
