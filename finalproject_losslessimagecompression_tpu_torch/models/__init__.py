from .config import (
    CouplingCfg,
    DenseBlockCfg,
    FlowCfg,
    LevelPlan,
    latent_shapes,
    level_plans,
    with_growth_multiple,
)
from .layers import (
    DenseBlock,
    DenseLayer,
    ResBlock,
    activation,
    pad_growth_params,
)
from .invertible import (
    AdditiveCoupling,
    Prior,
    coupling_split,
    inverse_permutation,
    permutation,
)
from .idflow import IDFlow, flow_permutations, log_likelihood
from .exact import FlowCodec
from .vqvae import VQVAE, VectorQuantizer, build_vqvae_from_ref, vq_reinit
from .residual_codec import ResidualCodec
from .twolevel import TwoLevelCfg, TwoLevelFlow, adaptive_pool_matrix
from .twolevel_codec import TwoLevelCodec

__all__ = [
    "CouplingCfg",
    "DenseBlockCfg",
    "FlowCfg",
    "LevelPlan",
    "latent_shapes",
    "level_plans",
    "with_growth_multiple",
    "DenseBlock",
    "DenseLayer",
    "ResBlock",
    "activation",
    "pad_growth_params",
    "AdditiveCoupling",
    "Prior",
    "coupling_split",
    "inverse_permutation",
    "permutation",
    "IDFlow",
    "flow_permutations",
    "log_likelihood",
    "FlowCodec",
    "ResidualCodec",
    "VQVAE",
    "VectorQuantizer",
    "build_vqvae_from_ref",
    "vq_reinit",
    "TwoLevelCfg",
    "TwoLevelFlow",
    "TwoLevelCodec",
    "adaptive_pool_matrix",
]
