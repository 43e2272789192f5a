"""Sharded full-model compression: FlowCodec over a mesh of ranks.

Extends parallel/codec.py (raw latent tensors) to the whole pipeline: the
flows, the priors and the rANS coding run on each rank over its batch
shard, so stream state never crosses a rank and every rank's containers
are byte-identical to a single-device `FlowCodec.compress` of its shard
(same backend, same local batch shape).  Any shard's containers decode
alone on one device.

The per-rank work is literally `FlowCodec.compress` / `decompress` of the
local shard (on the card: the rANS kernels, one launch per level each
way, replayed as CUDA graphs under the default "fused" granularity),
with one collective each way: the containers reach every rank with one
all_gather of objects, the decoded shards with one all_gather.  No coder
semantics fork.  Unlike the JAX class, decompress does not refuse a shard
with more than `FlowCodec.MAX_OUTLIERS` out-of-window escapes in a
container: the rank's FlowCodec decodes that queue through its level path
(counted in its `level_fallbacks`), so any container it wrote decodes here
too.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..models.exact import FlowCodec
from .codec import gather_checked, local_rows
from .mesh import Mesh


class ShardedFlowCodec:
    """Chip-local FlowCodec over a mesh.

    compress returns (blobs, info) where blobs is a flat list of
    D * nsplit containers (device-major: rank d's level-l container at
    index d * nsplit + l), each rank's decodable by a plain FlowCodec
    given that rank's shard."""

    def __init__(self, codec: FlowCodec, mesh: Mesh):
        self.codec = codec
        self.mesh = mesh
        self.D = mesh.size
        self.cfg = codec.cfg

    def _cond(self, cond):
        return None if cond is None else local_rows(cond, self.mesh,
                                                    self.codec.device)

    def compress(self, x, cond=None) -> Tuple[List[bytes], dict]:
        """x: the global batch [B, H, W, C] on the 1/256 grid, the same on
        every rank (cond likewise, for a conditional flow)."""
        batch = int(x.shape[0])
        blobs, _ = self.codec.compress(
            local_rows(x, self.mesh, self.codec.device), self._cond(cond))
        every = self.mesh.all_gather_object(blobs)
        return [b for rank in every for b in rank], {"batch": batch,
                                                     "devices": self.D}

    def decompress(self, blobs: Sequence[bytes], info: dict, cond=None,
                   fetch: bool = False):
        """The whole batch, on every rank: a device tensor, or numpy with
        fetch=True."""
        D, nsplit = self.D, self.cfg.nsplit
        if info["devices"] != D or len(blobs) != D * nsplit:
            raise ValueError(
                f"{len(blobs)} containers from {info['devices']} devices; "
                f"this mesh decodes {D} x {nsplit}")
        r = self.mesh.rank
        local = {"batch": info["batch"] // D}
        mine = list(blobs[r * nsplit:(r + 1) * nsplit])
        cond = self._cond(cond)

        def decode():
            xs, oks = self.codec.decode_queue(
                [(mine, local)], None if cond is None else [cond])
            return xs[0], oks

        return gather_checked(self.mesh, decode, fetch)

    def real_bpd(self, blobs: Sequence[bytes], info: dict) -> float:
        cfg = self.cfg
        numel = info["batch"] * cfg.H * cfg.W * cfg.C
        return sum(8 * len(b) for b in blobs) / float(numel)
