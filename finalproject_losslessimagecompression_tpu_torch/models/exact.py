"""FlowCodec: bit-exact image compression and decompression with IDFlow and
interleaved rANS.

Decoding regenerates every prior from already-decoded data, level by level
(nsplit-1 down to 0), interleaved with the rANS decode.

Bit-exactness.  Grid arithmetic (gathers, space-to-depth, adds of 1/256-grid
values) is exact in float32.  The NN evaluations are the only risk: the
priors must give identical (mean, logscale) at both ends, since they
parameterise the rANS CDF, and the coupling shifts t(xa) of the forward pass
must equal those of the inverse pass.  Both directions therefore call the
same two functions, `IDFlow.prior_params` and `IDFlow.couple_t`, on inputs
of the same shapes made contiguous the same way, and a codec on the card
pins cuDNN and cuBLAS to deterministic float32 arithmetic: building a CUDA
FlowCodec sets `torch.backends.cudnn.deterministic = True`,
`torch.backends.cudnn.benchmark = False`,
`torch.backends.cudnn.allow_tf32 = False` and
`torch.backends.cuda.matmul.allow_tf32 = False` for the process.

Host syncs.  `compress_many` queues every level of every batch and then
packs all containers with one device-to-host copy; `decompress_many` queues
every decode (the containers go up through pinned, non-blocking copies) and
checks every state invariant, plus the decoded images with fetch=True, in
one device-to-host copy.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..codec.coder import decode_streams_deferred, encode_tensor_deferred
from ..codec.container import pack_streams_many, unpack_streams
from ..codec.interleaved import make_seeds, pick_num_streams
from ..ops.reshape import depth_to_space, space_to_depth
from .idflow import IDFlow, fold_batch, unfold_batch


def set_deterministic_cuda() -> None:
    """Deterministic cuDNN algorithms, no autotuning, no TF32."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class FlowCodec:
    """Lossless codec over an IDFlow.  It runs on the model's device; a
    container decodes only on the backend (CPU or card) that encoded it,
    because the CDF's `exp` is not bit-equal across backends."""

    # symbols per stream: level 0 is the only unseeded level (nothing is
    # decoded after it, so nothing can recover donated words from it) and
    # pays ~37 bits of flush per stream, so its streams are longer.  Seeded
    # levels pay only the ~4-bit chain header per stream and stay wide.
    UNSEEDED_SYM_PER_STREAM = 256
    SEEDED_SYM_PER_STREAM = 64

    def __init__(self, model: IDFlow, num_streams: int = 8192):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.num_streams = num_streams
        self.plans = model.plans
        if self.device.type == "cuda":
            set_deterministic_cuda()

    # ------------------------------------------------------------------
    # stream policy
    # ------------------------------------------------------------------

    def _level_sps(self, level: int) -> int:
        if level == 0 and self.cfg.nsplit > 1:
            return self.UNSEEDED_SYM_PER_STREAM
        return self.SEEDED_SYM_PER_STREAM

    def _level_S(self, level: int, fold: int) -> int:
        p = self.plans[level]
        return pick_num_streams(fold * p.z_ch * p.h * p.w, self.num_streams,
                                self._level_sps(level))

    # ------------------------------------------------------------------
    # compress
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _compress_deferred(self, x):
        """Queue the whole encode of one batch without a host sync; returns
        (per-level EncodedStreams, info).

        Bits-back chain: level l + 1's streams are seeded from level l's
        word buffer, and level l's container omits those donated words.
        The decoder walks levels nsplit-1 .. 0, so when it needs level l's
        buffer it has decoded level l + 1 and holds the donated words as
        that decode's final lo limbs."""
        cfg, model = self.cfg, self.model
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        batch = int(x.shape[0])
        fold = 1 if cfg.batch_squeeze else batch
        if cfg.batch_squeeze:
            x = fold_batch(x, cfg.batch_squeeze)
        encs: List = []
        seeds = None
        for level, p in enumerate(self.plans):
            last = level == cfg.nsplit - 1
            x = model.flow_level(space_to_depth(x, cfg.extend_scale), level)
            z, keep = (x, None) if last else (x[..., : p.z_ch],
                                              x[..., p.z_ch:])
            mean, logscale = model.prior_params(z if last else keep, level)
            enc = encode_tensor_deferred(
                z, mean, logscale, self.num_streams, seeds,
                sym_per_stream=self._level_sps(level),
            )
            encs.append(enc)
            if not last:
                S_next = self._level_S(level + 1, fold)
                seeds = make_seeds(enc.words, enc.num_words, S_next)
                # clamped to the word count at pack time
                enc.donated = S_next
            x = keep
        return encs, {"batch": batch}

    def compress(self, x) -> Tuple[List[bytes], dict]:
        """Encode an image batch (NHWC, values on the 1/256 grid) to
        per-level containers.  Returns (blobs, info)."""
        encs, info = self._compress_deferred(x)
        return pack_streams_many(encs), info

    def compress_many(self, xs):
        """Serving encode: queue every batch, then pack every container with
        one host sync.  Returns a list of (blobs, info)."""
        per_batch = [self._compress_deferred(x) for x in xs]
        blobs = pack_streams_many([e for encs, _ in per_batch for e in encs])
        out, pos = [], 0
        for encs, info in per_batch:
            out.append((blobs[pos : pos + len(encs)], info))
            pos += len(encs)
        return out

    # ------------------------------------------------------------------
    # decompress
    # ------------------------------------------------------------------

    def _unpack_checked(self, blobs: Sequence[bytes], fold: int):
        """Unpack and validate the containers against the level plans."""
        if len(blobs) != self.cfg.nsplit:
            raise ValueError(f"expected {self.cfg.nsplit} containers, "
                             f"got {len(blobs)}")
        encs = [unpack_streams(b) for b in blobs]
        for level, e in enumerate(encs):
            p = self.plans[level]
            want_n = fold * p.z_ch * p.h * p.w
            want_S = self._level_S(level, fold)
            if e.n != want_n or e.num_streams != want_S:
                raise ValueError(
                    f"container level {level}: symbol count/streams "
                    f"({e.n}, {e.num_streams}) do not match the model "
                    f"plan ({want_n}, {want_S})"
                )
        return [e.to(self.device) for e in encs]

    @torch.no_grad()
    def _decompress_deferred(self, blobs: Sequence[bytes], info: dict):
        """Queue the whole decode of one batch; returns (x, oks) with oks
        the per-level state-invariant flags, still on the device."""
        cfg, model = self.cfg, self.model
        batch = info["batch"]
        fold = 1 if cfg.batch_squeeze else batch
        encs = self._unpack_checked(blobs, fold)
        x = None
        prev_lo = None
        oks = []
        for level in range(cfg.nsplit - 1, -1, -1):
            p = self.plans[level]
            last = level == cfg.nsplit - 1
            ref = (torch.zeros((fold, p.h, p.w, p.z_ch), device=self.device)
                   if last else x)
            mean, logscale = model.prior_params(ref, level)
            # this container's donated hole is restored from the previous
            # level's final lo limbs; the check skips this level's own
            # seeded prefix (its donor's donated count), and level 0's full
            # check closes the chain
            tail = 0 if level == 0 else encs[level - 1].donated
            z, ok, prev_lo = decode_streams_deferred(
                encs[level], mean, logscale,
                fill=None if last else prev_lo, tail_start=tail,
            )
            oks.append(ok)
            x = z if last else torch.cat([z, x], dim=-1)
            x = depth_to_space(model.flow_level_inverse(x, level),
                               cfg.extend_scale)
        if cfg.batch_squeeze:
            x = unfold_batch(x, cfg.C)[:batch]
        return x, oks

    @staticmethod
    def _check_got(got) -> None:
        if not all(bool(np.all(g)) for g in got):
            raise ValueError(
                "rANS decode failed: state did not return to 2^32")

    def _fetch(self, xs, oks):
        """One device-to-host copy of the decoded batches and the flags."""
        flat = torch.cat([x.reshape(-1) for x in xs]
                         + [torch.stack(oks).to(torch.float32)])
        host = flat.cpu().numpy()
        self._check_got([host[host.size - len(oks):] == 1.0])
        out, pos = [], 0
        for x in xs:
            out.append(host[pos : pos + x.numel()].reshape(tuple(x.shape)))
            pos += x.numel()
        return out

    def decompress(self, blobs: Sequence[bytes], info: dict,
                   fetch: bool = False):
        """Decode containers back to the exact input batch.  fetch=True
        returns a host numpy array, copied in the same transfer as the
        state-invariant check; the default returns a device tensor."""
        return self.decompress_many([(blobs, info)], fetch=fetch)[0]

    def decompress_many(self, packed, fetch: bool = False):
        """Serving decode of [(blobs, info), ...]: queue every batch's
        decode, then verify all state invariants with one host sync
        (fetch=True also returns the batches, as numpy, in that sync)."""
        xs, oks = [], []
        for blobs, info in packed:
            x, ok = self._decompress_deferred(blobs, info)
            xs.append(x)
            oks.extend(ok)
        if fetch:
            return self._fetch(xs, oks)
        self._check_got([bool(torch.stack(oks).all())])
        return xs

    # ------------------------------------------------------------------

    @staticmethod
    def coded_bits(blobs: Sequence[bytes]) -> int:
        return sum(8 * len(b) for b in blobs)

    def real_bpd(self, blobs: Sequence[bytes], info: dict) -> float:
        """Coded bits per input dim, all container overhead included."""
        cfg = self.cfg
        numel = info["batch"] * cfg.H * cfg.W * cfg.C
        return self.coded_bits(blobs) / float(numel)
