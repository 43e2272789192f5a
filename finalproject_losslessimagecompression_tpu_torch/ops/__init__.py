"""Grid rounding, layout transforms, the discretized logistic and the
VQ-VAE's reconstruction likelihoods."""

from .distributions import BinomialDistribution, UnitGaussianDistribution
from .dlogistic import dlogistic_log_prob, dlogistic_sample
from .reshape import depth_to_space, patch_merge, patch_split, space_to_depth
from .rounding import round_ste, round_to_grid

__all__ = [
    "BinomialDistribution",
    "UnitGaussianDistribution",
    "dlogistic_log_prob",
    "dlogistic_sample",
    "depth_to_space",
    "patch_merge",
    "patch_split",
    "space_to_depth",
    "round_ste",
    "round_to_grid",
]
