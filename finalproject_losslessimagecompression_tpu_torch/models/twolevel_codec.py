"""TwoLevelCodec: lossless coding with the two-level pyramid flow.

  compress:   pad -> pool to the rough size, rounded to the grid -> rough
              IDFlow + rANS; fine residual = padded - upsampled rough ->
              tiles -> fine IDFlow + rANS.
  decompress: rough first, then the fine tiles, then x = upsampled rough +
              merged fine tiles, cropped.

A batch's containers are the rough flow's (one per rough split level),
then the fine flow's.  The queue forms hand every batch's rough image to
one `FlowCodec` queue and every batch's fine tiles to another, and pack or
fetch everything in one copy each way, so a queue pass launches each rANS
kernel once per (sub-flow, level, stream layout): twice for
configs/config_twolevel.yaml (nsplit 1 on both sub-flows) when the
batches have one size.  The containers are byte-identical to per-batch
coding.  As every codec here, it names its queue without a host sync
`encode_queue` and `decode_queue` (models/exact.py).

Exactness needs the upsampling to keep the 1/256 grid, which holds when
the coded dims are multiples of the rough dims (the upsampling rows are
then one-hot: a replication).  For any other geometry the codec pads
further, by replication, to the smallest dims (Hc, Wc) divisible by both
the rough dims and the fine tile dims, codes those and crops on decode.
The geometry is a function of the config, so no side information is
coded; the rough image then averages a few replicated edge rows more than
the trainer's, a rate detail, since the decoder reads the rough image from
the stream.  x - unpool(rx) and unpool(rx) + fx are exact in float32 on
the grid; the two sub-flows keep `FlowCodec`'s determinism contract.

Granularity.  `TwoLevelCodec(model, num_streams, granularity)` hands the
mode to both sub-flows' FlowCodecs, which resolve it as every FlowCodec
does: None is "fused" on a CUDA device (each sub-flow's compress and
decompress of a queue one CUDA graph replay, from a queue signature's
second call on) and "level" on the CPU.  The containers are
byte-identical across the modes.  The pyramid's own work (pad, pool,
round, unpool, tiling and merge) runs eagerly between the sub-flows'
programs, once per batch.

Counters and spans (`utils.profiling.span`, none inside a captured
program):
- `twolevel.split`: `_split`, the compress side's pad, pool, round,
  unpool and tiling of one batch; counted in `splits`;
- `twolevel.merge`: the decompress side's unpool, tile merge and crop of
  one batch; counted in `merges`.
`tiles` counts the fine tiles split and merged.  The sub-flows' own
counters and spans (`captures`, `replays`, `eager_calls`, `evictions`,
`level_fallbacks`) stay on `rough_codec` and `fine_codec`.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ..ops.reshape import patch_merge, patch_split
from ..ops.rounding import round_to_grid
from ..utils.profiling import span
from .exact import FlowCodec, finish, pack_queue
from .twolevel import TwoLevelFlow, adaptive_pool_matrix, pad_edge, pool2d


def _coded_dim(padded: int, rough: int, tile: int) -> int:
    """The smallest multiple of lcm(rough, tile) that covers `padded`."""
    m = math.lcm(rough, tile)
    return -(-padded // m) * m


class TwoLevelCodec:
    """`granularity` goes to both sub-flows' FlowCodecs: None is "fused" on
    a CUDA device and "level" on the CPU (module docstring)."""

    def __init__(self, model: TwoLevelFlow, num_streams: int = 4096,
                 granularity: str | None = None):
        cfg = model.cfg
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.rough_codec = FlowCodec(model.rough, num_streams, granularity)
        self.fine_codec = FlowCodec(model.fine, num_streams, granularity)
        self.granularity = self.rough_codec.granularity
        self.splits = 0  # batches split (`twolevel.split`)
        self.merges = 0  # batches merged (`twolevel.merge`)
        self.tiles = 0  # fine tiles split and merged
        if cfg.Hp % cfg.rough.H or cfg.Wp % cfg.rough.W:
            self.Hc = _coded_dim(cfg.Hp, cfg.rough.H, cfg.fine.H)
            self.Wc = _coded_dim(cfg.Wp, cfg.rough.W, cfg.fine.W)
        else:
            self.Hc, self.Wc = cfg.Hp, cfg.Wp
        self._own_pool = (self.Hc, self.Wc) != (cfg.Hp, cfg.Wp)
        if self._own_pool:
            mats = [adaptive_pool_matrix(*d) for d in (
                (self.Hc, cfg.rough.H), (self.Wc, cfg.rough.W),
                (cfg.rough.H, self.Hc), (cfg.rough.W, self.Wc))]
            self._ph, self._pw, self._uh, self._uw = (
                torch.from_numpy(m).to(self.device) for m in mats)

    def _unpool(self, rx: torch.Tensor) -> torch.Tensor:
        if self._own_pool:
            return pool2d(rx, self._uh, self._uw)
        return self.model.unpool(rx)

    def _split(self, x: torch.Tensor):
        """-> (rough image, fine tiles) over the coded dims."""
        cfg = self.cfg
        with span("twolevel.split"):
            self.splits += 1
            if self._own_pool:
                x = pad_edge(x, self.Hc - cfg.H, self.Wc - cfg.W)
                rx = round_to_grid(pool2d(x, self._ph, self._pw), cfg.nbits)
                px = patch_split(x - self._unpool(rx), cfg.fine.H, cfg.fine.W)
            else:
                rx, px = self.model.split_levels(x)
            self.tiles += int(px.shape[0])
            return rx, px

    def _merge(self, rx: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
        """(rough image, fine tiles) -> the batch, cropped."""
        cfg = self.cfg
        with span("twolevel.merge"):
            self.merges += 1
            self.tiles += int(px.shape[0])
            x = self._unpool(rx) + patch_merge(px, self.Hc, self.Wc)
            return x[:, :cfg.H, :cfg.W, :]

    # -- compress ---------------------------------------------------------

    @torch.no_grad()
    def encode_queue(self, xs):
        """Queue the encode of a queue of batches without a host sync: the
        rough images of all batches as one FlowCodec queue and their fine
        tiles as another.  Returns [(per-level EncodedStreams, info)] per
        batch, the rough streams first."""
        xs = [torch.as_tensor(x, dtype=torch.float32, device=self.device)
              for x in xs]
        splits = [self._split(x) for x in xs]
        rough = self.rough_codec.encode_queue([rx for rx, _ in splits])
        fine = self.fine_codec.encode_queue([px for _, px in splits])
        return [(list(r_encs) + list(f_encs),
                 {"batch": int(x.shape[0]), "rough": r_info, "fine": f_info})
                for x, (r_encs, r_info), (f_encs, f_info) in zip(xs, rough,
                                                                 fine)]

    def compress_many(self, xs):
        """Serving encode of a queue of batches: `encode_queue`, then every
        container packed with one host sync.  Returns a list of (blobs,
        info), the rough containers first in each."""
        return pack_queue(self.encode_queue(xs))

    def compress(self, x) -> Tuple[List[bytes], dict]:
        """Encode an NHWC batch on the 1/256 grid -> (blobs, info)."""
        return self.compress_many([x])[0]

    # -- decompress -------------------------------------------------------

    @torch.no_grad()
    def decode_queue(self, packed):
        """Queue the whole decode of [(blobs, info), ...] without a host
        sync, both sub-flows' queues; returns (xs, oks) as
        FlowCodec.decode_queue."""
        nr = self.cfg.rough.nsplit
        rxs, oks_r = self.rough_codec.decode_queue(
            [(blobs[:nr], info["rough"]) for blobs, info in packed])
        pxs, oks_f = self.fine_codec.decode_queue(
            [(blobs[nr:], info["fine"]) for blobs, info in packed])
        xs = [self._merge(rx, px) for rx, px in zip(rxs, pxs)]
        return xs, oks_r + oks_f

    def decompress(self, blobs: Sequence[bytes], info: dict,
                   fetch: bool = False):
        """-> x, exactly the compressed batch; fetch=True returns host
        numpy, copied with the state-invariant check."""
        return self.decompress_many([(blobs, info)], fetch)[0]

    def decompress_many(self, packed, fetch: bool = False):
        """Serving decode of [(blobs, info), ...]: both sub-flows' queues,
        then every state invariant checked with one host sync (fetch=True
        also returns the batches, as numpy, in that sync)."""
        return finish(*self.decode_queue(packed), fetch)

    def real_bpd(self, blobs: Sequence[bytes], info: dict) -> float:
        cfg = self.cfg
        numel = info["batch"] * cfg.H * cfg.W * cfg.C
        return FlowCodec.coded_bits(blobs) / float(numel)
