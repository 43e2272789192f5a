"""ResidualCodec: lossless coding with a VQ-VAE and a conditional flow.

  compress:   x -> VQ indices (bit-packed `VQIX` stream) + conditional-flow
              containers of the residual tiles, conditioned on the
              reconstruction's tiles
  decompress: indices -> reconstruction -> conditional decode of the
              residual -> x, exactly.

A container decodes with no side information: the receiver rebuilds the
reconstruction from the index stream.  Both ends compute it with one
function, `_rec_from_idx` (round_to_grid(decode(codebook[idx]) * 0.5 + 0.5)),
on the same batch shape, and a codec on the card pins cuDNN and cuBLAS to
deterministic float32 arithmetic (`utils.graphs.set_deterministic_cuda`),
so both ends condition the flow's priors on the same bits.  x - rec and
res + rec are exact in float32 on the 1/256 grid.

The flow part of a queue goes to the FlowCodec whole, so under its
default granularity on the card ("fused") it is one CUDA graph replay
each way; the VQ encode and the reconstruction run eagerly.  As every
codec here, it names its queue without a host sync `encode_queue` and
`decode_queue` (models/exact.py).

Index stream cost: ceil(log2(K)) bits per index, counted in coded_bits and
real_bpd.

Program spans (`utils.profiling.span`; the flow's own are FlowCodec's,
its `codec.compress` and `codec.decompress` around the flow's queue
alone): `residual.compress` and `residual.decompress`, all of each call;
`residual.vq_encode` (`_encode_idx`); `residual.reconstruct`
(`_rec_from_idx`, both directions); `residual.index_pack` (the indices'
device-to-host copy, a `codec.sync`, then the bit packing);
`residual.index_unpack` (the bit unpacking and the indices' upload).
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.reshape import patch_merge, patch_split
from ..ops.rounding import round_to_grid
from ..utils.graphs import set_deterministic_cuda
from ..utils.profiling import span
from .exact import FlowCodec, finish, pack_queue
from .vqvae import VQVAE

_IDX_MAGIC = b"VQIX"


def _index_bits(K: int) -> int:
    return max(1, int(np.ceil(np.log2(max(K, 2)))))


def _pack_indices(idx: np.ndarray, K: int) -> bytes:
    """[B, h, w] indices -> bit-packed stream (little-endian bit order)
    behind a magic and a (B, h, w, K) header."""
    b, h, w = idx.shape
    bits = _index_bits(K)
    flat = idx.astype(np.uint32).ravel()
    if np.any(flat >= K):
        raise ValueError("index out of range")
    out = np.zeros((flat.size * bits + 7) // 8, np.uint8)
    pos = np.arange(flat.size, dtype=np.int64) * bits
    for j in range(bits):
        bit = ((flat >> j) & 1).astype(np.uint8)
        p = pos + j
        np.bitwise_or.at(out, p >> 3, bit << (p & 7).astype(np.uint8))
    return _IDX_MAGIC + struct.pack("<IIII", b, h, w, K) + out.tobytes()


def _unpack_indices(blob: bytes) -> Tuple[np.ndarray, int]:
    """-> ([B, h, w] int32, K); raises ValueError on a malformed stream."""
    if blob[:4] != _IDX_MAGIC or len(blob) < 20:
        raise ValueError("bad index stream magic")
    b, h, w, K = struct.unpack("<IIII", blob[4:20])
    bits = _index_bits(K)
    n = b * h * w
    if len(blob) != 20 + (n * bits + 7) // 8:
        raise ValueError("index stream length mismatch")
    buf = np.frombuffer(blob, np.uint8, offset=20)
    pos = np.arange(n, dtype=np.int64) * bits
    flat = np.zeros(n, np.uint32)
    for j in range(bits):
        p = pos + j
        flat |= ((buf[p >> 3] >> (p & 7).astype(np.uint8)) & 1).astype(
            np.uint32) << j
    if np.any(flat >= K):
        raise ValueError("index out of range")
    return flat.reshape(b, h, w).astype(np.int32), K


class ResidualCodec:
    """A frozen VQ-VAE coupled with a conditional FlowCodec on the same
    device.  The flow's config gives the tile dims; `input_size` is the
    (H, W) of the images being coded."""

    def __init__(self, vqvae: VQVAE, flow_codec: FlowCodec,
                 input_size: Tuple[int, int]):
        if not flow_codec.cfg.conditional:
            raise ValueError("ResidualCodec needs a conditional flow")
        if vqvae.device != flow_codec.device:
            raise ValueError("the VQ-VAE and the flow are on different "
                             f"devices ({vqvae.device}, {flow_codec.device})")
        self.vqvae = vqvae
        self.codec = flow_codec
        self.device = flow_codec.device
        self.input_size = tuple(input_size)
        self.K = int(vqvae.embed_num)
        if self.device.type == "cuda":
            set_deterministic_cuda()

    # -- the two functions both ends call ---------------------------------

    @torch.no_grad()
    def _encode_idx(self, x: torch.Tensor) -> torch.Tensor:
        with span("residual.vq_encode"):
            vq_x, _, idx, _, _ = self.vqvae.encode((x - 0.5) / 0.5)
            b, hh, ww, _ = vq_x.shape
            return idx.reshape(b, hh, ww)

    @torch.no_grad()
    def _rec_from_idx(self, idx: torch.Tensor) -> torch.Tensor:
        """The conditioning reconstruction of [B, h, w] indices."""
        with span("residual.reconstruct"):
            vq_x = self.vqvae.vq.codebook[idx.to(torch.int64)]
            rec = self.vqvae.decode(vq_x)
            return round_to_grid(rec * 0.5 + 0.5, self.codec.cfg.nbits)

    def _tiles(self, t: torch.Tensor) -> torch.Tensor:
        cfg = self.codec.cfg
        return patch_split(t, cfg.H, cfg.W)

    # -- API ----------------------------------------------------------------

    def compress(self, x) -> Tuple[bytes, List[bytes], dict]:
        """x [B, H, W, C] on the 1/256 grid -> (index stream, residual
        containers, info)."""
        return self.compress_many([x])[0]

    def encode_queue(self, xs):
        """Queue every batch's VQ encode and reconstruction, then the whole
        queue of residual tiles, with their conditioning tiles, as one
        FlowCodec queue, without a host sync: [(the flow's per-level
        EncodedStreams, info)] per batch, info["idx"] the batch's indices
        on the device."""
        H, W = self.input_size
        idxs, res, conds = [], [], []
        for x in xs:
            with span("codec.stage"):
                x = torch.as_tensor(x, dtype=torch.float32,
                                    device=self.device)
            if tuple(x.shape[1:3]) != (H, W):
                raise ValueError(f"batch of {tuple(x.shape[1:3])} "
                                 f"images, codec input size {(H, W)}")
            idx = self._encode_idx(x)
            rec = self._rec_from_idx(idx)
            idxs.append(idx)
            res.append(self._tiles(x - rec))
            conds.append(self._tiles(rec))
        with span("codec.compress"):
            per = self.codec.encode_queue(res, conds)
        return [(encs, {**info, "images": int(x.shape[0]), "idx": idx})
                for (encs, info), x, idx in zip(per, xs, idxs)]

    def compress_many(self, xs):
        """Serving encode: the queue (`encode_queue`; one rANS launch per
        level per stream layout), then one copy of the containers to the
        host and one more of the indices.  Byte-identical to per-batch
        compress.  Returns a list of (idx_blob, blobs, info)."""
        with span("residual.compress"):
            per = self.encode_queue(xs)
            idxs = [info.pop("idx") for _, info in per]
            packed = pack_queue(per)
            out = []
            with span("residual.index_pack"):
                flat = torch.cat([i.reshape(-1) for i in idxs])
                with span("codec.sync"):
                    host = flat.cpu().numpy()
                pos = 0
                for idx, (blobs, info) in zip(idxs, packed):
                    n = idx.numel()
                    idx_blob = _pack_indices(
                        host[pos:pos + n].reshape(idx.shape), self.K)
                    pos += n
                    out.append((idx_blob, blobs, info))
            return out

    @torch.no_grad()
    def decode_queue(self, packed):
        """Queue the whole decode of [(idx_blob, blobs, info), ...] without
        a host sync; returns (xs, oks) as FlowCodec.decode_queue."""
        H, W = self.input_size
        with span("residual.index_unpack"):
            idx_np = [_unpack_indices(idx_blob)[0]
                      for idx_blob, _, _ in packed]
            flat = torch.from_numpy(np.concatenate([i.reshape(-1)
                                                    for i in idx_np]))
            flat = flat.to(self.device)  # one copy up for every batch
        recs, pos = [], 0
        for i in idx_np:
            recs.append(self._rec_from_idx(
                flat[pos:pos + i.size].reshape(i.shape)))
            pos += i.size
        with span("codec.decompress"):
            tiles, oks = self.codec.decode_queue(
                [(blobs, info) for _, blobs, info in packed],
                [self._tiles(r) for r in recs])
        return [patch_merge(t, H, W) + r for t, r in zip(tiles, recs)], oks

    def decompress(self, idx_blob: bytes, blobs: Sequence[bytes],
                   info: dict, fetch: bool = False):
        """-> x [B, H, W, C], exactly the compressed batch; fetch=True
        returns host numpy, copied with the state-invariant check."""
        return self.decompress_many([(idx_blob, blobs, info)], fetch)[0]

    def decompress_many(self, packed, fetch: bool = False):
        """Serving decode of [(idx_blob, blobs, info), ...]: every batch is
        queued, then all state invariants are checked with one host sync
        (fetch=True also returns the batches, as numpy, in that sync)."""
        with span("residual.decompress"):
            return finish(*self.decode_queue(packed), fetch)

    def coded_bits(self, idx_blob: bytes, blobs: Sequence[bytes]) -> int:
        return 8 * len(idx_blob) + FlowCodec.coded_bits(blobs)

    def real_bpd(self, idx_blob: bytes, blobs: Sequence[bytes],
                 info: dict) -> float:
        H, W = self.input_size
        numel = info["images"] * H * W * self.codec.cfg.C
        return self.coded_bits(idx_blob, blobs) / float(numel)
