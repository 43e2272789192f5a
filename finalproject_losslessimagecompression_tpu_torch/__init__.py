"""PyTorch and CUDA port of the lossless image compression framework, for
NVIDIA Hopper (H100).

The JAX package `finalproject_losslessimagecompression_tpu` beside it is the
reference; this package imports neither it nor JAX.  It does what the JAX
package does (its bench aside): the codecs (`FlowCodec` over `IDFlow`, the
residual and two-level pipelines) with the interleaved-rANS entropy coder
as hand-written CUDA kernels, the trainers, the file codec CLI, the tools,
and scale-out over ranks of `torch.distributed`.

Package layout (module names mirror the JAX package):
    ops/        grid rounding, space-to-depth, discretized logistic
    codec/      quantized CDF, plain interleaved rANS, CUDA kernels
                (cuda_rans.py), LIC2 containers, latent coder
    models/     config, DenseBlock, couplings and priors, IDFlow, FlowCodec
    csrc/       CUDA (rANS kernels) and C++ (container state chain) sources,
                compiled at first use into build/
    data/       datasets and the batching loader (numpy)
    train/      optimizers and schedules, metrics, checkpoints, the trainers
    parallel/   process-group meshes, sharded steps, sharded codecs and VQ
                search, the multi-process runtime, the scaling harness
    utils/      timing and FLOP accounting
    cli/        training, file codec, scaling and tool entry points, the
                YAML-subset reader
    registry.py name -> constructor registries for the configs
    convert.py  flax parameter trees and optax states -> this package's
                state_dicts

Entry points run on the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
