"""FlowCodec: bit-exact image compression and decompression with IDFlow and
interleaved rANS.

Decoding regenerates every prior from already-decoded data, level by level
(nsplit-1 down to 0), interleaved with the rANS decode.  A conditional flow
takes one conditioning image per batch (`conds`); both directions compute
its per-level features once per batch with `IDFlow.cond_features`.

Bit-exactness.  Grid arithmetic (gathers, space-to-depth, adds of 1/256-grid
values) is exact in float32.  The NN evaluations are the only risk: the
priors must give identical (mean, logscale) at both ends, since they
parameterise the rANS CDF, and the coupling shifts t(xa) of the forward pass
must equal those of the inverse pass.  Both directions therefore call the
same functions, `IDFlow.prior_params`, `IDFlow.couple_t` and
`IDFlow.cond_features`, on inputs of the same shapes made contiguous the
same way, and a codec on the card pins cuDNN and cuBLAS to deterministic
float32 arithmetic: building a CUDA
FlowCodec sets `torch.backends.cudnn.deterministic = True`,
`torch.backends.cudnn.benchmark = False`,
`torch.backends.cudnn.allow_tf32 = False` and
`torch.backends.cuda.matmul.allow_tf32 = False` for the process.

Host syncs.  `compress_many` queues every level of every batch and then
packs all containers with one device-to-host copy; `decompress_many` queues
every decode (the containers go up through pinned, non-blocking copies) and
checks every state invariant, plus the decoded images with fetch=True, in
one device-to-host copy.

Launches.  Both walk the queue level-major: at each level every batch's
flow and prior run, then one rANS launch codes that level's containers of
all batches (one per stream layout, should batch sizes differ), so a queue
of any length launches each coding kernel once per level.  The containers
are byte-identical to per-batch coding: the batches' streams never mix.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..codec.coder import decode_streams_deferred_many, encode_tensors_deferred
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

    def _features(self, conds, n: int):
        """Per batch, the per-level conditioning features (None for an
        unconditional flow)."""
        if not self.cfg.conditional:
            return [self.model._conds(None)] * n
        if conds is None or len(conds) != n:
            raise ValueError("a conditional flow needs one cond per batch")
        return [self.model._conds(torch.as_tensor(
            c, dtype=torch.float32, device=self.device)) for c in conds]

    @torch.no_grad()
    def _compress_deferred_many(self, xs, conds=None):
        """Queue the whole encode of a queue of batches without a host
        sync, level-major; returns [(per-level EncodedStreams, info)] per
        batch.

        Bits-back chain: level l + 1's streams are seeded from level l's
        word buffer, and level l's container omits those donated words.
        The decoder walks levels nsplit-1 .. 0, so when it needs level l's
        buffer it has decoded level l + 1 and holds the donated words as
        that decode's final lo limbs."""
        cfg, model = self.cfg, self.model
        xs = [torch.as_tensor(x, dtype=torch.float32, device=self.device)
              for x in xs]
        infos = [{"batch": int(x.shape[0])} for x in xs]
        folds = [1 if cfg.batch_squeeze else info["batch"] for info in infos]
        if cfg.batch_squeeze:
            xs = [fold_batch(x, cfg.batch_squeeze) for x in xs]
        feats = self._features(conds, len(xs))
        encs: List[List] = [[] for _ in xs]
        seeds = [None] * len(xs)
        for level, p in enumerate(self.plans):
            last = level == cfg.nsplit - 1
            items = []
            for b, x in enumerate(xs):
                x = model.flow_level(space_to_depth(x, cfg.extend_scale),
                                     level)
                z, keep = (x, None) if last else (x[..., : p.z_ch],
                                                  x[..., p.z_ch:])
                mean, logscale = model.prior_params(z if last else keep,
                                                    level, feats[b][level])
                items.append((z, mean, logscale))
                xs[b] = keep
            level_encs = encode_tensors_deferred(
                items, self.num_streams, seeds,
                sym_per_stream=self._level_sps(level),
            )
            for b, enc in enumerate(level_encs):
                encs[b].append(enc)
                if not last:
                    S_next = self._level_S(level + 1, folds[b])
                    seeds[b] = make_seeds(enc.words, enc.num_words, S_next)
                    # clamped to the word count at pack time
                    enc.donated = S_next
        return list(zip(encs, infos))

    def compress(self, x, cond=None) -> Tuple[List[bytes], dict]:
        """Encode an image batch (NHWC, values on the 1/256 grid) to
        per-level containers.  Returns (blobs, info)."""
        return self.compress_many([x], None if cond is None else [cond])[0]

    def compress_many(self, xs, conds=None):
        """Serving encode: queue every batch, then pack every container with
        one host sync.  Returns a list of (blobs, info)."""
        per_batch = self._compress_deferred_many(xs, conds)
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
    def _decompress_deferred_many(self, packed, conds=None):
        """Queue the whole decode of [(blobs, info), ...], level-major;
        returns (xs, oks) with oks the per-level state-invariant flags,
        still on the device."""
        cfg, model = self.cfg, self.model
        batches = [info["batch"] for _, info in packed]
        folds = [1 if cfg.batch_squeeze else b for b in batches]
        encs = [self._unpack_checked(blobs, fold)
                for (blobs, _), fold in zip(packed, folds)]
        feats = self._features(conds, len(packed))
        xs = [None] * len(packed)
        prev_lo = [None] * len(packed)
        oks = []
        for level in range(cfg.nsplit - 1, -1, -1):
            p = self.plans[level]
            last = level == cfg.nsplit - 1
            params = [
                model.prior_params(
                    torch.zeros((fold, p.h, p.w, p.z_ch), device=self.device)
                    if last else x, level, f[level])
                for fold, x, f in zip(folds, xs, feats)
            ]
            # each container's donated hole is restored from the previous
            # level's final lo limbs; the check skips this level's own
            # seeded prefix (its donor's donated count), and level 0's full
            # check closes the chain
            decoded = decode_streams_deferred_many(
                [e[level] for e in encs], [m for m, _ in params],
                [ls for _, ls in params],
                fills=None if last else prev_lo,
                tail_starts=[0 if level == 0 else e[level - 1].donated
                             for e in encs],
            )
            for b, (z, ok, lo) in enumerate(decoded):
                oks.append(ok)
                prev_lo[b] = lo
                x = z if last else torch.cat([z, xs[b]], dim=-1)
                xs[b] = depth_to_space(model.flow_level_inverse(x, level),
                                       cfg.extend_scale)
        if cfg.batch_squeeze:
            xs = [unfold_batch(x, cfg.C)[:batch]
                  for x, batch in zip(xs, batches)]
        return xs, oks

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

    def decompress(self, blobs: Sequence[bytes], info: dict, cond=None,
                   fetch: bool = False):
        """Decode containers back to the exact input batch.  fetch=True
        returns a host numpy array, copied in the same transfer as the
        state-invariant check; the default returns a device tensor."""
        return self.decompress_many([(blobs, info)],
                                    None if cond is None else [cond],
                                    fetch=fetch)[0]

    def decompress_many(self, packed, conds=None, fetch: bool = False):
        """Serving decode of [(blobs, info), ...] (with one cond per batch
        for a conditional flow): queue every batch's decode, level-major,
        then verify all state invariants with one host sync (fetch=True
        also returns the batches, as numpy, in that sync)."""
        xs, oks = self._decompress_deferred_many(packed, conds)
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
