"""Sharded VQ codebook lookup over the mesh's `tile` ranks.

For large codebooks (the configs use 8192 x 512) the distance matmul and
the codebook itself shard over the `tile` axis: each rank scores only its
K / tile codebook rows, the ranks exchange (local minimum, global index)
pairs with an all_gather, and the winning rows are fetched with a masked
all_reduce sum; no rank forms the whole [N, K] distance matrix.

Also the cross-rank usage-count reduction, so that every rank applies the
same dead-code reinit (models/vqvae.py: vq_reinit).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh
from .sharding import shard_batch


def _tensor(x, device):
    x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.float32)


def sharded_vq_lookup(x, codebook, mesh: Mesh, axis: str = "tile"):
    """x: [N, D], codebook: [K, D], both the same on every rank; rank t of
    the `axis` group scores codebook rows [t*K/n, (t+1)*K/n).

    Returns (vq_x [N, D], idx [N] int64) identical to a single-device
    argmin lookup (ties broken toward the lowest global index)."""
    K = int(codebook.shape[0])
    nshards = mesh.shape[axis]
    if K % nshards:
        raise ValueError(f"{K} codewords do not shard over {nshards} ranks")
    ks = K // nshards
    shard = mesh.coords[axis]
    x = _tensor(x, mesh.device)
    cb = _tensor(codebook, mesh.device)[shard * ks:(shard + 1) * ks]
    d = ((x * x).sum(1, keepdim=True) + (cb * cb).sum(1)
         - 2.0 * (x @ cb.T))  # [N, ks]
    lv, li = d.min(1)  # the first minimum: the lowest local index
    gi = li + shard * ks
    vs = mesh.all_gather(lv, axis)  # [nshards, N]
    gs = mesh.all_gather(gi, axis)
    win = vs.argmin(0)  # the first minimum: the lowest shard
    idx = gs.gather(0, win[None])[0]
    mine = torch.div(idx, ks, rounding_mode="floor") == shard
    rows = torch.where(mine[:, None], cb[torch.where(mine, idx % ks, 0)],
                       torch.zeros((), device=cb.device))
    return mesh.all_reduce(rows, axis=axis), idx


def psum_counts(per_device_counts, mesh: Mesh) -> torch.Tensor:
    """All-reduce per-device usage counts [n_devices_total, K] (the same
    on every rank, each rank owning its rows) -> [K], so that every rank
    applies the identical dead-code reinit.  The sharded VQ-VAE trainer
    reduces its step's counts with the same all_reduce."""
    c = _tensor(per_device_counts, mesh.device)
    return mesh.all_reduce(shard_batch(c, mesh).sum(0))
