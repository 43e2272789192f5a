"""Sharded serving for the full pipelines: ResidualCodec and TwoLevelCodec
over a mesh of ranks.

parallel/flow_codec.py scales the plain FlowCodec; this module extends the
same chip-local pattern to the two composite codecs:

- images shard over the ranks (the patch order is image-major, so every
  image's patches stay on its rank);
- each rank runs the VQ encode and reconstruction, or the pyramid's split
  and unpool, on its own images, with no collective;
- each rank codes with the single-device codec itself, so its containers
  (and its bit-packed VQ index stream) are byte-identical to a
  single-device ResidualCodec / TwoLevelCodec compress of its images.  Any
  shard decodes alone.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..models.residual_codec import ResidualCodec
from ..models.twolevel_codec import TwoLevelCodec
from .codec import gather_checked, local_rows
from .mesh import Mesh


class ShardedResidualCodec:
    """Chip-local residual-pipeline codec over a mesh.

    compress returns (idx_blobs, blobs, info): idx_blobs[d] is rank d's
    bit-packed VQ index stream and blobs[d*nsplit + l] its level-l flow
    container, together exactly what a plain ResidualCodec.compress of
    rank d's images emits."""

    def __init__(self, res_codec: ResidualCodec, mesh: Mesh):
        self.res = res_codec
        self.mesh = mesh
        self.D = mesh.size

    def compress(self, x) -> Tuple[List[bytes], List[bytes], dict]:
        """x: the global image batch, the same on every rank."""
        B = int(x.shape[0])
        idx_blob, blobs, info = self.res.compress(
            local_rows(x, self.mesh, self.res.device))
        every = self.mesh.all_gather_object((idx_blob, blobs))
        return ([i for i, _ in every], [b for _, bl in every for b in bl],
                {"batch": info["batch"] * self.D, "devices": self.D,
                 "images": B})

    def decompress(self, idx_blobs: Sequence[bytes], blobs: Sequence[bytes],
                   info: dict, fetch: bool = False):
        """The whole image batch, on every rank."""
        D, nsplit = self.D, self.res.codec.cfg.nsplit
        if len(idx_blobs) != D or len(blobs) != D * nsplit:
            raise ValueError(
                f"{len(idx_blobs)} index streams and {len(blobs)} "
                f"containers; this mesh decodes {D} and {D} x {nsplit}")
        r = self.mesh.rank
        local = {"batch": info["batch"] // D, "images": info["images"] // D}
        mine = (idx_blobs[r], list(blobs[r * nsplit:(r + 1) * nsplit]),
                local)

        def decode():
            xs, oks = self.res.decode_queue([mine])
            return xs[0], oks

        return gather_checked(self.mesh, decode, fetch)

    def coded_bits(self, idx_blobs, blobs) -> int:
        return 8 * sum(len(b) for b in idx_blobs) + sum(
            8 * len(b) for b in blobs)

    def real_bpd(self, idx_blobs, blobs, info: dict) -> float:
        H, W = self.res.input_size
        numel = info["images"] * H * W * self.res.codec.cfg.C
        return self.coded_bits(idx_blobs, blobs) / float(numel)


class ShardedTwoLevelCodec:
    """Chip-local two-level pyramid codec over a mesh.

    Blob layout: D * rough.nsplit rough containers (device-major), then
    D * fine.nsplit fine containers (device-major); rank d's slice
    (`device_slice`) is exactly TwoLevelCodec.compress of its images."""

    def __init__(self, codec: TwoLevelCodec, mesh: Mesh):
        self.tl = codec
        self.mesh = mesh
        self.D = mesh.size

    def compress(self, x) -> Tuple[List[bytes], dict]:
        """x: the global image batch, the same on every rank."""
        cfg, D = self.tl.cfg, self.D
        blobs, info = self.tl.compress(local_rows(x, self.mesh,
                                                  self.tl.device))
        every = self.mesh.all_gather_object(blobs)
        nr = cfg.rough.nsplit
        out = ([b for bl in every for b in bl[:nr]]
               + [b for bl in every for b in bl[nr:]])
        return out, {"batch": info["batch"] * D, "devices": D,
                     "rough": {"batch": info["rough"]["batch"] * D,
                               "devices": D},
                     "fine": {"batch": info["fine"]["batch"] * D,
                              "devices": D}}

    def decompress(self, blobs: Sequence[bytes], info: dict,
                   fetch: bool = False):
        """The whole image batch, on every rank."""
        cfg, D = self.tl.cfg, self.D
        if len(blobs) != D * (cfg.rough.nsplit + cfg.fine.nsplit):
            raise ValueError(f"{len(blobs)} containers; this mesh decodes "
                             f"{D} x ({cfg.rough.nsplit} + "
                             f"{cfg.fine.nsplit})")
        local = {"batch": info["batch"] // D,
                 "rough": {"batch": info["rough"]["batch"] // D},
                 "fine": {"batch": info["fine"]["batch"] // D}}
        mine = (self.device_slice(blobs, self.mesh.rank), local)

        def decode():
            xs, oks = self.tl.decode_queue([mine])
            return xs[0], oks

        return gather_checked(self.mesh, decode, fetch)

    def device_slice(self, blobs: Sequence[bytes], d: int) -> List[bytes]:
        """Rank d's containers in plain TwoLevelCodec.compress order."""
        cfg = self.tl.cfg
        nr, nf = cfg.rough.nsplit, cfg.fine.nsplit
        rough_all = blobs[: self.D * nr]
        fine_all = blobs[self.D * nr:]
        return (list(rough_all[d * nr:(d + 1) * nr])
                + list(fine_all[d * nf:(d + 1) * nf]))

    def real_bpd(self, blobs: Sequence[bytes], info: dict) -> float:
        cfg = self.tl.cfg
        numel = info["batch"] * cfg.H * cfg.W * cfg.C
        return sum(8 * len(b) for b in blobs) / float(numel)
