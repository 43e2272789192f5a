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
float32 arithmetic: building a CUDA FlowCodec (its graph cache,
`utils.graphs.set_deterministic_cuda`) sets
`torch.backends.cudnn.deterministic = True`,
`torch.backends.cudnn.benchmark = False`,
`torch.backends.cudnn.allow_tf32 = False` and
`torch.backends.cuda.matmul.allow_tf32 = False` for the process.

Granularity.  `FlowCodec(model, num_streams, granularity)` takes the JAX
package's three modes; None picks "fused" on a CUDA device and "level" on
the CPU, as JAX picks "fused" on its accelerator.
- "level" runs the level-major pipeline eagerly, op by op.
- "nn" is accepted for JAX compatibility and is the level path (the codec
  reads "level").  The JAX mode runs every coupling NN through one shared
  executable so that both directions compute the same shifts; in eager
  torch every shift of both directions already goes through the one
  function `IDFlow.couple_t`.
- "fused" runs the whole compress and the whole decompress of a queue as
  one program each: `compress_pipeline` / `decompress_pipeline`, functions
  of static-shaped device tensors (JAX `_compress_all` / `_decompress_all`).
  On the card each is a CUDA graph of the codec's `utils.graphs.GraphCache`
  (`graph_cache`, one memory pool `graph_pool`), keyed by the queue's
  layout: the batch sizes, whether conds are given and, for a decompress,
  MAX_OUTLIERS.  So a one-off queue, such as a one-shot CLI command, runs
  eagerly and pays no capture, and the second call of a layout captures.
  A decompress queue's static input is its containers' padded form in one
  host tensor (`interleaved.pad_many`: the bits-back hole, the tail check
  and the escape patch read device values there, on every path).  A
  decompress queue with a container of more than `MAX_OUTLIERS` escapes
  takes the level path, as in JAX, and is counted in `level_fallbacks`.
  On the CPU the fused pipeline runs eagerly (there are no graphs).  The
  containers are byte-identical across the modes.

Counters and spans.  `captures`, `capture_seconds`, `replays`,
`eager_calls` and `evictions` are the graph cache's, and its spans are
`codec.eager` (a signature's first call, the level path and the CPU's
fused pipeline), `codec.capture`, `codec.evict`, `codec.stage`,
`codec.replay` and `codec.clone`; `level_fallbacks` counts queues decoded
by level for their escapes (`codec.level_fallback`).  Each counted event
is also a program span of the same name (`utils.profiling.span`: a
`record_function` range on the profiler's timeline while it records,
nothing otherwise).  The codec's own spans, at the host boundaries of the
two calls (none inside a captured pipeline, whose replay runs no Python):
- `codec.compress`: all of `compress_many`;
- `codec.decompress`: all of `decompress_many`, the check or fetch
  included (a ResidualCodec opens both around the flow's queue alone);
- `codec.unpack`: the containers' parse, validation and padded form;
- `codec.stage`: the images' upload and the static inputs' fill;
- `codec.pack` (`container.pack_streams_many`) and `codec.fetch`: the
  host side of the one device-to-host copy each, whose blocking copy is
  a `codec.sync` (the host waiting on the card), as is the state check.

Host syncs.  `encode_queue` and `decode_queue` queue a whole queue without
a host sync; every codec (FlowCodec, ResidualCodec, TwoLevelCodec) names
that seam so.  `compress_many` then packs all containers with one
device-to-host copy (`pack_queue`), and `decompress_many` checks every
state invariant, plus the decoded images with fetch=True, in one
device-to-host copy (`finish`).  The containers go up through pinned,
non-blocking copies.

Launches.  Both walk the queue level-major: at each level every batch's
flow and prior run, then one rANS launch codes that level's containers of
all batches (one per stream layout, should batch sizes differ), so a queue
of any length launches each coding kernel once per level.  A replayed
graph holds exactly those launches and adds them to the wrappers' counters
(`utils.graphs.CountedGraph`); its capture counts none.  The containers
are byte-identical to per-batch coding: the batches' streams never mix.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..codec.coder import decode_many_deferred, encode_tensors_deferred
from ..codec.container import pack_streams_many, unpack_streams
from ..codec.interleaved import (
    from_padded_many,
    make_seeds,
    pad_many,
    pick_num_streams,
    to_device,
)
from ..ops.reshape import depth_to_space, space_to_depth
from ..utils.graphs import GraphCache
from ..utils.profiling import span
from .idflow import IDFlow, fold_batch, unfold_batch

GRANULARITIES = ("fused", "level", "nn")


def pack_queue(per_batch):
    """[(blobs, info)] of an encoded queue [(per-level EncodedStreams,
    info)]: every container packed with one device-to-host copy, then
    split per batch."""
    blobs = pack_streams_many([e for encs, _ in per_batch for e in encs])
    out, pos = [], 0
    for encs, info in per_batch:
        out.append((blobs[pos:pos + len(encs)], info))
        pos += len(encs)
    return out


def finish(xs, oks, fetch: bool = False):
    """A decoded queue's batches once every state-invariant flag in `oks`
    (device booleans) holds, checked with one blocking copy: the device
    tensors, or with fetch=True host numpy arrays, copied in the same
    transfer as the flags.  Raises ValueError if a flag is false."""
    if fetch:
        with span("codec.fetch"):
            flat = torch.cat([x.reshape(-1) for x in xs]
                             + [torch.stack(oks).to(torch.float32)])
            with span("codec.sync"):
                host = flat.cpu().numpy()
            ok = bool(np.all(host[host.size - len(oks):] == 1.0))
            out, pos = [], 0
            for x in xs:
                out.append(host[pos:pos + x.numel()].reshape(tuple(x.shape)))
                pos += x.numel()
    else:
        with span("codec.sync"):
            ok = bool(torch.stack(oks).all())
        out = xs
    if not ok:
        raise ValueError("rANS decode failed: state did not return to 2^32")
    return out


class FlowCodec:
    """Lossless codec over an IDFlow.  It runs on the model's device; a
    container decodes only on the backend (CPU or card) that encoded it,
    because the CDF's `exp` is not bit-equal across backends.  See the
    module docstring for `granularity`."""

    # escapes per container that the fused decompress patches in the
    # program; an instance may override it
    MAX_OUTLIERS = 256

    # symbols per stream: level 0 is the only unseeded level (nothing is
    # decoded after it, so nothing can recover donated words from it) and
    # pays ~37 bits of flush per stream, so its streams are longer.  Seeded
    # levels pay only the ~4-bit chain header per stream and stay wide.
    UNSEEDED_SYM_PER_STREAM = 256
    SEEDED_SYM_PER_STREAM = 64

    def __init__(self, model: IDFlow, num_streams: int = 8192,
                 granularity: str | None = None):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.num_streams = num_streams
        self.plans = model.plans
        if granularity is None:
            granularity = "fused" if self.device.type == "cuda" else "level"
        if granularity not in GRANULARITIES:
            raise ValueError(f"granularity {granularity!r}: one of "
                             f"{GRANULARITIES} or None")
        # "nn" is the level path here (module docstring)
        self.granularity = "level" if granularity == "nn" else granularity
        self.level_fallbacks = 0  # fused decompress queues decoded by level
        # both directions' graphs ("fused" on the card); pins the
        # arithmetic contract on the card
        self.graph_cache = GraphCache(self.device, "codec")

    # the graph cache's counters and pool, which bench.py, chip_smoke.py
    # and lic_bench read
    graphs = property(lambda self: self.graph_cache.graphs)
    captures = property(lambda self: self.graph_cache.captures)
    capture_seconds = property(lambda self: self.graph_cache.capture_seconds)
    replays = property(lambda self: self.graph_cache.replays)
    eager_calls = property(lambda self: self.graph_cache.eager_calls)
    evictions = property(lambda self: self.graph_cache.evictions)
    graph_pool = property(lambda self: self.graph_cache.pool)

    # ------------------------------------------------------------------
    # stream policy
    # ------------------------------------------------------------------

    def _level_sps(self, level: int) -> int:
        if level == 0 and self.cfg.nsplit > 1:
            return self.UNSEEDED_SYM_PER_STREAM
        return self.SEEDED_SYM_PER_STREAM

    def _level_n(self, level: int, fold: int) -> int:
        p = self.plans[level]
        return fold * p.z_ch * p.h * p.w

    def _level_S(self, level: int, fold: int) -> int:
        return pick_num_streams(self._level_n(level, fold), self.num_streams,
                                self._level_sps(level))

    # ------------------------------------------------------------------
    # the pipelines (functions of device tensors, no host value read)
    # ------------------------------------------------------------------

    def _conds_on_device(self, conds, n: int):
        """A conditional flow's conds, one per batch, as float32 tensors on
        the codec's device (None for an unconditional flow)."""
        if not self.cfg.conditional:
            return None
        if conds is None or len(conds) != n:
            raise ValueError("a conditional flow needs one cond per batch")
        return [torch.as_tensor(c, dtype=torch.float32, device=self.device)
                for c in conds]

    def _features(self, conds, n: int):
        """Per batch, the per-level conditioning features (None for an
        unconditional flow)."""
        if not self.cfg.conditional:
            return [self.model._conds(None)] * n
        return [self.model._conds(c) for c in conds]

    @torch.no_grad()
    def compress_pipeline(self, xs, conds=None):
        """The whole encode of a queue of batches (float32 tensors on the
        device; conds likewise, or None), level-major, without a host
        sync: per batch, its per-level EncodedStreams.

        Bits-back chain: level l + 1's streams are seeded from level l's
        word buffer, and level l's container omits those donated words.
        The decoder walks levels nsplit-1 .. 0, so when it needs level l's
        buffer it has decoded level l + 1 and holds the donated words as
        that decode's final lo limbs."""
        cfg, model = self.cfg, self.model
        folds = [1 if cfg.batch_squeeze else int(x.shape[0]) for x in xs]
        xs = [fold_batch(x, cfg.batch_squeeze) if cfg.batch_squeeze else x
              for x in xs]
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
        return encs

    @torch.no_grad()
    def decompress_pipeline(self, encs, batches, conds=None):
        """The whole decode of a queue, level-major, without a host sync:
        encs[b] is batch b's per-level containers in their padded form on
        the device (`interleaved.upload`: every count a device value),
        batches[b] its batch size.  Returns (xs, oks)
        with oks the per-level state-invariant flags, on the device."""
        cfg, model = self.cfg, self.model
        folds = [1 if cfg.batch_squeeze else b for b in batches]
        feats = self._features(conds, len(encs))
        xs = [None] * len(encs)
        prev_lo = [None] * len(encs)
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
            decoded = decode_many_deferred(
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

    # ------------------------------------------------------------------
    # compress
    # ------------------------------------------------------------------

    def encode_queue(self, xs, conds=None):
        """Queue the whole encode of a queue of batches without a host
        sync; returns [(per-level EncodedStreams, info)] per batch."""
        with span("codec.stage"):
            xs = [torch.as_tensor(x, dtype=torch.float32, device=self.device)
                  for x in xs]
            conds = self._conds_on_device(conds, len(xs))
        if self.granularity == "fused":
            key = ("compress", tuple(int(x.shape[0]) for x in xs),
                   conds is not None)
            encs = self.graph_cache(key, self.compress_pipeline, (xs, conds))
        else:
            encs = self.graph_cache.eager(
                lambda: self.compress_pipeline(xs, conds))
        return [(e, {"batch": int(x.shape[0])}) for e, x in zip(encs, xs)]

    def compress(self, x, cond=None) -> Tuple[List[bytes], dict]:
        """Encode an image batch (NHWC, values on the 1/256 grid) to
        per-level containers.  Returns (blobs, info)."""
        return self.compress_many([x], None if cond is None else [cond])[0]

    def compress_many(self, xs, conds=None):
        """Serving encode: queue every batch, then pack every container with
        one host sync.  Returns a list of (blobs, info)."""
        with span("codec.compress"):
            return pack_queue(self.encode_queue(xs, conds))

    # ------------------------------------------------------------------
    # decompress
    # ------------------------------------------------------------------

    def _unpack_checked(self, blobs: Sequence[bytes], fold: int):
        """Unpack and validate the containers against the level plans
        (host arrays)."""
        if len(blobs) != self.cfg.nsplit:
            raise ValueError(f"expected {self.cfg.nsplit} containers, "
                             f"got {len(blobs)}")
        encs = [unpack_streams(b) for b in blobs]
        for level, e in enumerate(encs):
            want_n = self._level_n(level, fold)
            want_S = self._level_S(level, fold)
            if e.n != want_n or e.num_streams != want_S:
                raise ValueError(
                    f"container level {level}: symbol count/streams "
                    f"({e.n}, {e.num_streams}) do not match the model "
                    f"plan ({want_n}, {want_S})"
                )
        return encs

    def decode_queue(self, packed, conds=None):
        """Queue the whole decode of [(blobs, info), ...]; returns (xs, oks)
        with oks the per-level state-invariant flags, still on the
        device."""
        batches = [info["batch"] for _, info in packed]
        folds = [1 if self.cfg.batch_squeeze else b for b in batches]
        with span("codec.unpack"):
            encs = [self._unpack_checked(blobs, fold)
                    for (blobs, _), fold in zip(packed, folds)]
            # one layout for every path: the containers' padded forms,
            # escapes padded to MAX_OUTLIERS (or to a container's own
            # count past it)
            host, layouts = pad_many([e for es in encs for e in es],
                                     self.MAX_OUTLIERS)
        with span("codec.stage"):
            conds = self._conds_on_device(conds, len(packed))
        nl = self.cfg.nsplit

        def pipeline(flat, sconds):
            views = from_padded_many(flat[0], layouts)
            return self.decompress_pipeline(
                [views[b * nl:(b + 1) * nl] for b in range(len(batches))],
                batches, sconds)

        def level():
            with span("codec.stage"):
                flat = to_device(host, self.device)
            return pipeline([flat], conds)

        if self.granularity != "fused":
            return self.graph_cache.eager(level)
        if all(m == self.MAX_OUTLIERS for _, _, m in layouts):
            key = ("decompress", tuple(batches), conds is not None,
                   self.MAX_OUTLIERS)
            return self.graph_cache(key, pipeline, ([host], conds))
        with span("codec.level_fallback"):
            self.level_fallbacks += 1
            return self.graph_cache.eager(level)

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
        with span("codec.decompress"):
            return finish(*self.decode_queue(packed, conds), fetch)

    # ------------------------------------------------------------------

    @staticmethod
    def coded_bits(blobs: Sequence[bytes]) -> int:
        return sum(8 * len(b) for b in blobs)

    def real_bpd(self, blobs: Sequence[bytes], info: dict) -> float:
        """Coded bits per input dim, all container overhead included."""
        cfg = self.cfg
        numel = info["batch"] * cfg.H * cfg.W * cfg.C
        return self.coded_bits(blobs) / float(numel)
