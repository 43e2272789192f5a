"""PyTorch and CUDA port of the lossless image compression framework, for
NVIDIA Hopper (H100).

The JAX package `finalproject_losslessimagecompression_tpu` beside it is the
reference; this package imports neither it nor JAX.  Ported so far: the
plain flow codec's serving path, `FlowCodec` over an unconditional `IDFlow`,
with its interleaved-rANS entropy coder as two hand-written CUDA kernels.

Package layout (module names mirror the JAX package):
    ops/        grid rounding, space-to-depth, discretized logistic
    codec/      quantized CDF, plain interleaved rANS, CUDA kernels
                (cuda_rans.py), LIC2 containers, latent coder
    models/     config, DenseBlock, couplings and priors, IDFlow, FlowCodec
    csrc/       CUDA (rANS kernels) and C++ (container state chain) sources,
                compiled at first use into build/
    convert.py  flax parameter trees -> this package's state_dict

Entry points run on the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
