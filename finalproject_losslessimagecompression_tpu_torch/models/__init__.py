from .config import (
    CouplingCfg,
    DenseBlockCfg,
    FlowCfg,
    LevelPlan,
    latent_shapes,
    level_plans,
)
from .layers import DenseBlock, DenseLayer, activation
from .invertible import (
    AdditiveCoupling,
    Prior,
    coupling_split,
    inverse_permutation,
    permutation,
)
from .idflow import IDFlow, flow_permutations, log_likelihood
from .exact import FlowCodec

__all__ = [
    "CouplingCfg",
    "DenseBlockCfg",
    "FlowCfg",
    "LevelPlan",
    "latent_shapes",
    "level_plans",
    "DenseBlock",
    "DenseLayer",
    "activation",
    "AdditiveCoupling",
    "Prior",
    "coupling_split",
    "inverse_permutation",
    "permutation",
    "IDFlow",
    "flow_permutations",
    "log_likelihood",
    "FlowCodec",
]
