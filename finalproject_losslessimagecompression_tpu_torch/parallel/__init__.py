"""Scale-out on torch.distributed: one process per device, a process
group as the device mesh, data-parallel train steps, chip-local sharded
codecs, the sharded VQ codebook search, the multi-process runtime and the
scaling harness."""

from .codec import sharded_decode, sharded_encode
from .mesh import make_mesh, mesh_shape_for
from .sharding import (
    make_sharded_eval_step,
    make_sharded_train_step,
    replicate,
    shard_batch,
)
from .vq import psum_counts, sharded_vq_lookup

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "make_sharded_train_step",
    "make_sharded_eval_step",
    "replicate",
    "shard_batch",
    "sharded_vq_lookup",
    "sharded_encode",
    "sharded_decode",
    "psum_counts",
]
