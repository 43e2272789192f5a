"""Sharded, chip-local rANS coding over a mesh of ranks.

The batch shards over the mesh and every rank runs its own interleaved
rANS streams over its local shard: stream state never crosses a rank, so
each rank's container is byte-identical to a single-device encode of that
shard (`codec.coder.encode_tensor`, the same stream plan), whatever the
mesh, and any rank's container decodes alone on one device.  On a CUDA
tensor the coding launches the rANS kernels (`codec/cuda_rans.py`), or
raises.  The containers reach every rank with one all_gather.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..codec.coder import decode_streams_deferred, encode_tensor
from ..codec.container import unpack_streams
from ..codec.interleaved import upload
from .mesh import Mesh
from .sharding import shard_batch


def local_rows(x, mesh: Mesh, device) -> torch.Tensor:
    """This rank's rows of a global batch, as float32 on `device`."""
    x = shard_batch(x, mesh)
    x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.float32)


def gather_checked(mesh: Mesh, decode, fetch: bool = False):
    """Run this rank's `decode()` -> (x, oks), agree across the mesh that
    every rank's containers parsed and every state invariant held
    (ValueError on every rank otherwise), then gather the shards in rank
    order: the whole batch, as numpy with fetch=True."""
    try:
        x, oks = decode()
        ok = bool(torch.stack(oks).all())
    except ValueError:
        x, ok = None, False
    mesh.check(ok, "rANS decode failed: a shard's container is corrupt or "
               "its state did not return to 2^32")
    full = mesh.all_gather(x)
    full = full.reshape(-1, *full.shape[2:])
    return full.cpu().numpy() if fetch else full


def sharded_encode(latents, means, logscales, mesh: Mesh,
                   num_streams: int = 8192) -> List[bytes]:
    """Encode a batch-sharded latent tensor to ONE container per rank.

    latents/means/logscales: [B, ...] with B divisible by the mesh size;
    rank i codes rows [i*b, (i+1)*b).  Returns the mesh-size containers
    in rank order, on every rank."""
    blob = encode_tensor(*(local_rows(t, mesh, mesh.device)
                           for t in (latents, means, logscales)),
                         num_streams)
    return mesh.all_gather_object(blob)


def sharded_decode(blobs: Sequence[bytes], means, logscales, mesh: Mesh):
    """Decode per-rank containers back to the whole latent tensor.

    means/logscales must be the (regenerated) parameter tensors used at
    encode time.  Returns float32 grid values in means' shape on the
    mesh's device, on every rank; raises ValueError on every rank if any
    rank's container is malformed or its streams fail the state
    invariant.  Out-of-window escapes ride each container's own side
    channel."""
    if len(blobs) != mesh.size:
        raise ValueError(f"{len(blobs)} containers for {mesh.size} ranks")
    m, ls = (local_rows(t, mesh, mesh.device) for t in (means, logscales))

    def decode():
        x, ok, _ = decode_streams_deferred(
            upload([unpack_streams(blobs[mesh.rank])], mesh.device)[0], m, ls)
        return x, [ok]

    return gather_checked(mesh, decode).reshape(tuple(means.shape))
