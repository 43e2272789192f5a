"""File-level compress/decompress CLI: images <-> `.lic` containers.

Compress an image file (a uint8 .npy array, a PNG, or anything PIL reads)
into a self-describing `.lic` file with a trained checkpoint, and decompress
it back to the exact original pixels:

  python -m finalproject_losslessimagecompression_tpu_torch.cli.codec compress \\
      --config configs/synthetic64.yaml --ckpt logs/synthetic64.ckpt \\
      --input img.png [img2.npy ...] [--outdir DIR] [--device cpu]
  python -m finalproject_losslessimagecompression_tpu_torch.cli.codec decompress \\
      --config configs/synthetic64.yaml --ckpt logs/synthetic64.ckpt \\
      --input img.lic [--outdir DIR] [--device cpu]
  python -m finalproject_losslessimagecompression_tpu_torch.cli.codec serve \\
      --config ... --ckpt ...        # commands on stdin, see `serve`

The codec runs on the card unless `--device cpu` is given.  Checkpoints are
the port's (`{"params": state_dict}`, as its trainer writes them); the
config is read by the port's own YAML reader.

Pixels map uint8 v -> v/256 (points of the 1/256 coding grid).  Images are
replication-padded up to a multiple of the tile size, split into tiles
(patch_split) and coded in power-of-two tile batches (_chunk_sizes), so a
corpus of many image sizes meets few batch shapes; the original size is in
the header and the padding is cropped away on decompress.

Three pipelines, selected by the config's shape:
- `train.model` (IDFlows): FlowCodec over model-size tiles;
- `train.model` with `name: TwoLevelFlows`: TwoLevelCodec over (H, W)
  tiles, each chunk's segments the rough containers, then the fine ones;
- `train.flows` + `train.vqvae` (ResidualTrainer): ResidualCodec over
  `input_size` tiles.  The .lic carries the bit-packed VQ index stream (the
  first segment of each chunk) and the conditional residual containers, so
  it decodes with no side information.  The VQ checkpoint comes from the
  config's `vqvae.checkpoint` or `--vq-ckpt`.

`.lic` layout: magic b"LIC1" | u32 header_len | JSON header | blobs, the
JAX package's format version 2.  The header records the original size,
nbits, pipeline kind, per-chunk segment counts, blob lengths and a model
fingerprint: a hash of the model config, the compute variant (fused 1x1,
dtype, and the backend, torch-cuda or torch-cpu) and the checkpoints'
bytes.  A container written by another checkpoint, variant, backend or by
the JAX package fails loudly instead of decoding garbage.  The codecs run
at `--granularity` (default: the codec's own, so every pipeline runs
"fused" on the card: a command's queue runs eagerly the first time its
chunk layout is met and as a CUDA graph replay from the second time on,
at most `utils.graphs.GraphCache.MAX_GRAPHS` graphs kept per flow);
containers are byte-identical across the granularities, so the
fingerprint carries none, as in JAX.

Each file is stored as the smaller of the flow container and a stored
escape (`stored-png`, or `stored-zlib` for channel counts PNG does not take
and where PIL is not installed); stored containers are model-independent
and skip the fingerprint check.  `--no-stored-fallback` forces flow mode.
PIL is imported only to read or write PNG files and stored-png blobs.
Where it does not import, PNGs and stored-png blobs are read by the
package's own reader (`utils/png.py`: 8-bit grey, grey + alpha, RGB and
RGBA, non-interlaced) and decompressed files are written as `.npy`
(`--ext .npy`).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct

import numpy as np
import torch

from ..utils.profiling import PhaseTimer

# Phase clock of every load / compress / decompress region below, reported
# by `--timing` and the serve session's `timing` command.
TIMER = PhaseTimer()

_MAGIC = b"LIC1"
# flow-container format version (the JAX package's); stored-escape
# containers carry none
_FORMAT_VERSION = 2


class _PlainPipeline:
    """IDFlow configs (train.model): FlowCodec over model-size tiles."""

    name = "plain"

    def __init__(self, codec, fingerprint):
        self.codec = codec
        self.device = codec.device
        self.fingerprint = fingerprint
        cfg = codec.cfg
        self.tile_h, self.tile_w, self.C = cfg.H, cfg.W, cfg.C
        self.nbits = cfg.nbits

    def compress_many(self, tiles_list):
        """[tile batches] -> [(segments, info)]; the segments are written to
        the container in order."""
        return self.codec.compress_many(tiles_list)

    def decompress_many(self, packed):
        # the decoded batches come back with the state-invariant check, in
        # one host copy
        return self.codec.decompress_many(packed, fetch=True)


class _ResidualPipeline:
    """ResidualTrainer configs (train.flows + train.vqvae): ResidualCodec
    over input_size tiles; each chunk's first segment is its VQ index
    stream."""

    name = "residual"

    def __init__(self, res_codec, fingerprint):
        self.res = res_codec
        self.device = res_codec.device
        self.fingerprint = fingerprint
        self.tile_h, self.tile_w = res_codec.input_size
        self.C = res_codec.codec.cfg.C
        self.nbits = res_codec.codec.cfg.nbits

    def compress_many(self, tiles_list):
        return [([idx_blob] + list(blobs), info)
                for idx_blob, blobs, info in self.res.compress_many(
                    tiles_list)]

    def decompress_many(self, packed):
        return self.res.decompress_many(
            [(segs[0], segs[1:], info) for segs, info in packed], fetch=True)


class _TwoLevelPipeline:
    """TwoLevelFlows configs (train.model.name == TwoLevelFlows):
    TwoLevelCodec over (H, W) tiles, the rough containers then the fine
    ones."""

    name = "twolevel"

    def __init__(self, codec, fingerprint):
        self.codec = codec
        self.device = codec.device
        self.fingerprint = fingerprint
        cfg = codec.cfg
        self.tile_h, self.tile_w, self.C = cfg.H, cfg.W, cfg.C
        self.nbits = cfg.nbits

    def compress_many(self, tiles_list):
        return [(list(blobs), {"batch": info["batch"]})
                for blobs, info in self.codec.compress_many(tiles_list)]

    def decompress_many(self, packed):
        cfg = self.codec.cfg
        # fine tiles per image over the codec's coded dims
        ntiles = (self.codec.Hc // cfg.fine.H) * (self.codec.Wc // cfg.fine.W)
        full = [(segs, {"batch": int(info["batch"]),
                        "rough": {"batch": int(info["batch"])},
                        "fine": {"batch": int(info["batch"]) * ntiles}})
                for segs, info in packed]
        return self.codec.decompress_many(full, fetch=True)


def _flow_flags(cfg) -> str:
    c, p = cfg.couple.nn, cfg.prior_nn
    return (f"fuse={int(c.fuse_1x1)},{int(p.fuse_1x1)};"
            f"dtype={c.dtype},{p.dtype};"
            f"gm={c.growth_multiple},{p.growth_multiple}")


def _variant_tag(cfg, device: torch.device) -> str:
    """Resolved compute-variant flags per NN stack (both sub-flows' for a
    two-level config) and the backend.  The variants differ in float
    rounding, and so does the backend (the CDF's exp and the convolutions),
    so a container decodes bit-exactly only under the variant and backend
    that wrote it."""
    from ..models.twolevel import TwoLevelCfg

    flags = (f"rough[{_flow_flags(cfg.rough)}]fine[{_flow_flags(cfg.fine)}]"
             if isinstance(cfg, TwoLevelCfg) else _flow_flags(cfg))
    return f"{flags};backend=torch-{torch.device(device).type}"


def _fingerprint(model_cfg: dict, variant: str, *ckpt_paths: str) -> str:
    """Ties .lic files to the (architecture, compute variant, weights)
    triple."""
    h = hashlib.sha256()
    h.update(json.dumps(model_cfg, sort_keys=True).encode())
    h.update(variant.encode())
    for p in ckpt_paths:
        with open(p, "rb") as f:
            h.update(f.read(1 << 20))
    return h.hexdigest()[:16]


def _restore(module, ckpt_path: str, device, convert):
    """Load a checkpoint's params into the module: a `{"params":
    state_dict}` file of this package, or a JAX package checkpoint through
    `convert`, the module's converter."""
    from ..train.checkpoint import load_params

    try:
        module.load_state_dict(load_params(ckpt_path, device, convert))
    except ValueError as err:
        raise SystemExit(str(err)) from None
    return module.eval()


def _override_dense_dtype(node, dtype: str):
    """Set `dtype` on every DenseBlock subtree of a raw config dict (the
    bfloat16 serving variant; params stay float32)."""
    if isinstance(node, dict):
        if node.get("name") == "DenseBlock":
            node["dtype"] = dtype
        for v in node.values():
            _override_dense_dtype(v, dtype)
    elif isinstance(node, list):
        for v in node:
            _override_dense_dtype(v, dtype)


def _load_model(config_path: str, ckpt_path: str, num_streams: int,
                vq_ckpt: str = None, dtype: str = None, device=None,
                granularity: str = None):
    with TIMER.phase("startup:load_model"):
        return _load_model_timed(config_path, ckpt_path, num_streams,
                                 vq_ckpt, dtype, device, granularity)


def _load_model_timed(config_path, ckpt_path, num_streams, vq_ckpt, dtype,
                      device, granularity):
    from ..convert import (
        params_from_flax,
        twolevel_params_from_flax,
        vqvae_params_from_flax,
    )
    from ..models import (
        FlowCodec,
        IDFlow,
        ResidualCodec,
        TwoLevelCfg,
        TwoLevelCodec,
        TwoLevelFlow,
        build_vqvae_from_ref,
    )
    from ..models.config import FlowCfg
    from ..models.idflow import resolve_device
    from .train import load_config

    device = resolve_device(device)
    train = load_config(config_path)["train"]
    if dtype:
        _override_dense_dtype(train, dtype)

    if "flows" in train:  # ResidualTrainer config -> the residual pipeline
        flows = dict(train["flows"])
        flows.pop("load_path", None)
        cfg = FlowCfg.from_ref(flows)
        if not cfg.conditional:
            raise SystemExit(
                f"{config_path}: file coding of residual configs needs "
                "ConditionalFlows (the VQ reconstruction is the decoder's "
                "only conditioning source)")
        vq_cfg = dict(train["vqvae"])
        vq_ckpt = vq_ckpt or vq_cfg.get("checkpoint")
        if not vq_ckpt:
            raise SystemExit("no VQ-VAE checkpoint (config or --vq-ckpt)")
        model = _restore(IDFlow(cfg, device=device), ckpt_path, device,
                         params_from_flax)
        vqvae = _restore(build_vqvae_from_ref(vq_cfg, device=device),
                         vq_ckpt, device, vqvae_params_from_flax)
        res = ResidualCodec(vqvae, FlowCodec(model, num_streams,
                                             granularity),
                            tuple(train["input_size"]))
        fp = _fingerprint(flows, _variant_tag(cfg, device), ckpt_path,
                          vq_ckpt)
        return _ResidualPipeline(res, fp)

    model_cfg = dict(train["model"])
    model_cfg.pop("load_path", None)
    if model_cfg.get("name") == "TwoLevelFlows":
        tcfg = TwoLevelCfg.from_ref(model_cfg)
        model = _restore(TwoLevelFlow(tcfg, device=device), ckpt_path, device,
                         twolevel_params_from_flax)
        fp = _fingerprint(model_cfg, _variant_tag(tcfg, device), ckpt_path)
        return _TwoLevelPipeline(
            TwoLevelCodec(model, num_streams, granularity), fp)
    cfg = FlowCfg.from_ref(model_cfg)
    model = _restore(IDFlow(cfg, device=device), ckpt_path, device,
                     params_from_flax)
    fp = _fingerprint(model_cfg, _variant_tag(cfg, device), ckpt_path)
    return _PlainPipeline(FlowCodec(model, num_streams, granularity), fp)


def _pil_image(what: str):
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit(f"{what} needs PIL (Pillow), which is not "
                         "installed; use .npy files") from None
    return Image


def _read_image(path: str) -> np.ndarray:
    """-> uint8 [H, W, C]: a .npy array, or an image through PIL where it
    imports and, where not, a PNG through `utils.png`."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.dtype != np.uint8:
            raise SystemExit(f"{path}: expected uint8 array")
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr
    try:
        from PIL import Image
    except ImportError:
        # no PIL: 8-bit PNGs through the package's own reader, converted
        # as PIL's convert("RGB") converts them
        if not path.lower().endswith(".png"):
            raise SystemExit(f"reading {path} needs PIL (Pillow), which is "
                             "not installed; use .png or .npy files") from None
        from ..utils.png import PNGError, as_rgb, read_png

        try:
            return as_rgb(read_png(path))
        except PNGError as err:
            raise SystemExit(str(err)) from None
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def _write_image(path: str, arr: np.ndarray) -> None:
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    Image = _pil_image(f"writing {path}")
    Image.fromarray(arr.squeeze() if arr.shape[-1] == 1 else arr).save(path)


def _to_tiles(pipe, in_path):
    """image file -> (tile batch [N, th, tw, C] on the pipeline's device,
    original shape, uint8 array)."""
    from ..data.loader import _pad_replicate
    from ..ops.reshape import patch_split

    arr = _read_image(in_path)
    H, W, C = arr.shape
    if C != pipe.C:
        raise SystemExit(f"{in_path}: {C} channels, model expects {pipe.C}")
    x = arr.astype(np.float32) / 256.0
    x = _pad_replicate(x[None], -H % pipe.tile_h, -W % pipe.tile_w)
    tiles = np.ascontiguousarray(patch_split(x, pipe.tile_h, pipe.tile_w))
    return torch.from_numpy(tiles).to(pipe.device), (H, W, C), arr


def _stored_blob(arr: np.ndarray, src_path: str = None):
    """Smallest self-contained classical encoding of a uint8 HWC array:
    PNG (optimize=True, or the source .png's own bytes when they are
    smaller and decode to the same array) when PIL takes the channel count
    and is installed, raw zlib otherwise.  The container's worst case is the
    header plus the best of these."""
    import io
    import zlib

    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is None or arr.shape[-1] not in (1, 3):
        return "stored-zlib", zlib.compress(arr.tobytes(), 9)
    b = io.BytesIO()
    Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr).save(
        b, format="PNG", optimize=True)
    blob = b.getvalue()
    if src_path and src_path.lower().endswith(".png"):
        with open(src_path, "rb") as f:
            raw = f.read()
        if len(raw) < len(blob):
            try:
                rt = _decode_stored("stored-png", raw, arr.shape)
            except (Exception, SystemExit):
                rt = None
            if rt is not None and np.array_equal(rt, arr):
                blob = raw
    return "stored-png", blob


def _decode_stored(mode: str, blob: bytes, orig,
                   name: str = "<blob>") -> np.ndarray:
    """Decode a stored-escape blob, validating the decoded shape against
    the header's (H, W, C)."""
    H, W, C = orig
    if mode == "stored-png":
        import io

        try:
            from PIL import Image
        except ImportError:
            from ..utils.png import PNGError, read_png

            try:
                a = read_png(blob)
            except PNGError as err:
                raise SystemExit(f"{name}: a stored-png container: "
                                 f"{err}") from None
        else:
            a = np.asarray(Image.open(io.BytesIO(blob)), np.uint8)
        if a.ndim == 2:
            a = a[..., None]
        if a.shape != (H, W, C):
            raise SystemExit(f"{name}: stored-png decodes to {a.shape}, "
                             f"header says {(H, W, C)}")
        return a
    import zlib

    raw = zlib.decompress(blob)
    if len(raw) != H * W * C:
        raise SystemExit(f"{name}: stored-zlib decompresses to {len(raw)} "
                         f"bytes, header says {H * W * C}")
    return np.frombuffer(raw, np.uint8).reshape(H, W, C)


def _container_bytes(header: dict, segments) -> bytes:
    h = json.dumps(header).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(h)), h, *segments])


def _chunk_sizes(n: int, cap: int = 64):
    """Binary decomposition of a tile count into descending powers of two
    (each <= cap), e.g. 21 -> [16, 4, 1]: a corpus of many image sizes
    meets at most log2(cap) + 1 batch shapes, and every tile coded is a
    real tile."""
    out = []
    while n:
        out.append(min(1 << (n.bit_length() - 1), cap))
        n -= out[-1]
    return out


def _write_lic(pipe, out_path, file_packed, orig, in_path, arr=None):
    """Write the smaller of {flow container, stored escape} (arr=None
    always writes the flow container).  `file_packed`: [(segments, info)]
    per tile chunk of this file.  Returns the mode written."""
    segments = [b for segs, _ in file_packed for b in segs]
    flow = _container_bytes({
        "v": _FORMAT_VERSION,
        "orig": list(orig),
        "nbits": pipe.nbits,
        "pipeline": pipe.name,
        "mode": "flow",
        "chunks": [
            {"nseg": len(segs),
             "info": {k: v for k, v in info.items()
                      if isinstance(v, (int, float, str, bool))}}
            for segs, info in file_packed
        ],
        "blob_lens": [len(b) for b in segments],
        "fingerprint": pipe.fingerprint,
    }, segments)
    data, mode = flow, "flow"
    if arr is not None:
        smode, blob = _stored_blob(arr, src_path=in_path)
        stored = _container_bytes({
            "orig": list(orig),
            "pipeline": pipe.name,
            "mode": smode,
            "blob_lens": [len(blob)],
        }, [blob])
        if len(stored) < len(flow):
            data, mode = stored, smode
    with open(out_path, "wb") as f:
        f.write(data)
    H, W, C = orig
    print(f"{in_path} -> {out_path}: {len(data)} bytes, "
          f"{8.0 * len(data) / (H * W * C):.4f} bpd [{mode}]")
    return mode


def compress_files(pipe, in_paths, out_paths, stored_fallback=True,
                   max_chunk=64):
    """Every file's tile chunks are queued and packed with one host copy
    (the codecs' compress_many).  Returns the mode written per file."""
    chunks, per_file_nchunks, origs, arrs = [], [], [], []
    with TIMER.phase("compress:read_tile"):
        for p in in_paths:
            x, orig, arr = _to_tiles(pipe, p)
            off = 0
            sizes = _chunk_sizes(int(x.shape[0]), max_chunk)
            for b in sizes:
                chunks.append(x[off:off + b])
                off += b
            per_file_nchunks.append(len(sizes))
            origs.append(orig)
            arrs.append(arr if stored_fallback else None)
    # ends with host-visible bytes, so the phase needs no extra fence
    with TIMER.phase("compress:dispatch_pack"):
        packed = pipe.compress_many(chunks)
    modes = []
    with TIMER.phase("compress:escape_write"):
        pos = 0
        for in_path, out_path, nch, orig, arr in zip(
                in_paths, out_paths, per_file_nchunks, origs, arrs):
            modes.append(_write_lic(pipe, out_path, packed[pos:pos + nch],
                                    orig, in_path, arr))
            pos += nch
    return modes


def compress_file(pipe, in_path, out_path, stored_fallback=True):
    """compress_files of one file."""
    return compress_files(pipe, [in_path], [out_path], stored_fallback)[0]


def _read_lic(pipe, in_path):
    """-> (mode, [(segments, info)] per chunk, orig shape), with loud
    validation.  Stored-mode containers are model-independent, so the
    fingerprint and pipeline checks apply to flow mode only."""
    with open(in_path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC or len(data) < 8:
        raise SystemExit(f"{in_path}: not a .lic container")
    (hlen,) = struct.unpack("<I", data[4:8])
    try:
        header = json.loads(data[8:8 + hlen])
    except ValueError:
        raise SystemExit(f"{in_path}: corrupt header") from None
    if not isinstance(header, dict):
        raise SystemExit(f"{in_path}: corrupt header")
    # the schema is checked before any field is used
    blob_lens = header.get("blob_lens")
    orig = header.get("orig")
    if not (isinstance(blob_lens, list) and blob_lens
            and all(isinstance(n, int) and n >= 0 for n in blob_lens)):
        raise SystemExit(f"{in_path}: corrupt header (blob_lens)")
    if not (isinstance(orig, list) and len(orig) == 3
            and all(isinstance(d, int) and d > 0 for d in orig)):
        raise SystemExit(f"{in_path}: corrupt header (orig shape)")
    mode = header.get("mode", "flow")
    if mode == "flow":
        ver = header.get("v", 1)
        if ver != _FORMAT_VERSION:
            rel = "an older" if ver < _FORMAT_VERSION else "a newer"
            raise SystemExit(
                f"{in_path}: flow container format v{ver} was written by "
                f"{rel} version of this tool (this build reads "
                f"v{_FORMAT_VERSION}); re-compress the source image")
        if header.get("fingerprint") != pipe.fingerprint:
            raise SystemExit(
                f"{in_path}: was written by a different model/checkpoint, "
                f"compute variant or backend ({header.get('fingerprint')} "
                f"!= {pipe.fingerprint})")
        if header.get("pipeline", "plain") != pipe.name:
            raise SystemExit(
                f"{in_path}: {header.get('pipeline')!r} container, loaded "
                f"config is {pipe.name!r}")
    elif mode not in ("stored-png", "stored-zlib"):
        raise SystemExit(f"{in_path}: unknown container mode {mode!r}")
    segments, off = [], 8 + hlen
    for n in blob_lens:
        segments.append(data[off:off + n])
        off += n
    if off != len(data):
        raise SystemExit(f"{in_path}: trailing/missing bytes")
    if mode != "flow":
        return mode, [(segments, {"batch": 1})], orig
    chunks = header.get("chunks")
    if not (isinstance(chunks, list) and chunks
            and all(isinstance(c, dict)
                    and isinstance(c.get("nseg"), int)
                    and c["nseg"] >= 1
                    and isinstance(c.get("info", {}), dict)
                    for c in chunks)
            and sum(c["nseg"] for c in chunks) == len(segments)):
        raise SystemExit(f"{in_path}: corrupt header (chunks)")
    out, pos = [], 0
    for c in chunks:
        info = dict(c.get("info", {}))
        info.setdefault("batch", 1)
        out.append((segments[pos:pos + c["nseg"]], info))
        pos += c["nseg"]
    return mode, out, orig


def decompress_files(pipe, in_paths, out_paths):
    """Every container's chunks are queued before the one host sync that
    checks every state invariant and returns the tiles (the codecs'
    decompress_many with fetch=True).  Stored-mode containers decode on the
    host and never touch the model."""
    from ..ops.reshape import patch_merge

    with TIMER.phase("decompress:read_parse"):
        parsed = [_read_lic(pipe, p) for p in in_paths]
        entries = [(i, chunk) for i, (m, chunks, _) in enumerate(parsed)
                   if m == "flow" for chunk in chunks]
    with TIMER.phase("decompress:dispatch_verify"):
        recs = (pipe.decompress_many([c for _, c in entries])
                if entries else [])
        per_file = {}
        for (i, _), r in zip(entries, recs):
            per_file.setdefault(i, []).append(r)
    with TIMER.phase("decompress:merge_write"):
        for i, (in_path, out_path, (mode, chunks, orig)) in enumerate(
                zip(in_paths, out_paths, parsed)):
            H, W, C = orig
            if mode == "flow":
                tiles = np.concatenate(per_file[i], axis=0)
                full = patch_merge(tiles, H + (-H % pipe.tile_h),
                                   W + (-W % pipe.tile_w))
                arr = np.round(full[0, :H, :W, :C] * 256.0).astype(np.uint8)
            else:
                arr = _decode_stored(mode, chunks[0][0][0], orig,
                                     name=in_path)
            _write_image(out_path, arr)
            print(f"{in_path} -> {out_path}: {H}x{W}x{C} [{mode}]")


def decompress_file(pipe, in_path, out_path):
    """decompress_files of one file."""
    decompress_files(pipe, [in_path], [out_path])


def _out_path(path, ext, outdir):
    base = os.path.splitext(os.path.basename(path))[0]
    return os.path.join(outdir, base + ext)


def serve(pipe, lines=None, out=None, stored_fallback=True, max_chunk=64,
          ext=".png"):
    """Session mode: the loaded pipeline serves many commands, each paying
    only its marginal cost (tiling, coding, file IO), never the process
    start and model load.

    Line protocol on stdin (or `lines`), one command per line:
      compress <outdir> <in1> [in2 ...]
      decompress <outdir> <in1> [in2 ...]   (writes <name><ext>)
      timing        -> one JSON line {"phases": {...}} (accumulated)
      reset-timing
      quit
    After each compress/decompress: one line `ok <seconds>` (the command's
    wall clock); an unknown command answers `err ...`."""
    import sys
    import time

    def _emit(s):
        print(s, file=out, flush=True) if out else print(s, flush=True)

    src = lines if lines is not None else sys.stdin
    for line in src:
        parts = line.strip().split()
        if not parts:
            continue
        cmd = parts[0]
        if cmd == "quit":
            break
        if cmd == "timing":
            _emit(json.dumps({"phases": TIMER.report()}))
            continue
        if cmd == "reset-timing":
            TIMER.totals.clear()
            TIMER.counts.clear()
            continue
        if cmd not in ("compress", "decompress") or len(parts) < 3:
            _emit(f"err unknown command: {line.strip()!r}")
            continue
        outdir, paths = parts[1], parts[2:]
        os.makedirs(outdir, exist_ok=True)
        t0 = time.time()
        if cmd == "compress":
            compress_files(pipe, paths,
                           [_out_path(p, ".lic", outdir) for p in paths],
                           stored_fallback=stored_fallback,
                           max_chunk=max_chunk)
        else:
            decompress_files(pipe, paths,
                             [_out_path(p, ext, outdir) for p in paths])
        _emit(f"ok {time.time() - t0:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["compress", "decompress", "serve"])
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--input", nargs="+", default=None,
                    help="input files (compress/decompress modes)")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--num-streams", type=int, default=4096)
    ap.add_argument("--vq-ckpt", default=None,
                    help="VQ-VAE checkpoint for residual configs "
                    "(default: the config's vqvae.checkpoint)")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="override the conv stacks' compute dtype; the "
                    ".lic fingerprint covers it, so compress and "
                    "decompress must use the same setting")
    ap.add_argument("--no-stored-fallback", action="store_true",
                    help="always write flow containers, even when the "
                    "stored escape (PNG/zlib) would be smaller")
    ap.add_argument("--max-chunk", type=int, default=64,
                    help="largest tile-chunk batch (power-of-two "
                    "decomposition)")
    ap.add_argument("--ext", default=".png",
                    help="extension of decompressed files (.png or .npy)")
    ap.add_argument("--timing", action="store_true",
                    help="print the accumulated phase table (JSON) at exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                    "the CPU)")
    ap.add_argument("--granularity", default=None,
                    choices=["fused", "level", "nn"],
                    help="the codecs' granularity (default: the codec's "
                    "own, fused on the card and level on the CPU); the "
                    "containers are the same in every mode")
    args = ap.parse_args(argv)

    pipe = _load_model(args.config, args.ckpt, args.num_streams,
                       vq_ckpt=args.vq_ckpt, dtype=args.dtype,
                       device=args.device, granularity=args.granularity)
    if args.mode == "serve":
        serve(pipe, stored_fallback=not args.no_stored_fallback,
              max_chunk=args.max_chunk, ext=args.ext)
        return
    if not args.input:
        raise SystemExit("--input is required for compress/decompress")
    os.makedirs(args.outdir, exist_ok=True)
    if args.mode == "compress":
        compress_files(pipe, args.input,
                       [_out_path(p, ".lic", args.outdir)
                        for p in args.input],
                       stored_fallback=not args.no_stored_fallback,
                       max_chunk=args.max_chunk)
    else:
        decompress_files(pipe, args.input,
                         [_out_path(p, args.ext, args.outdir)
                          for p in args.input])
    if args.timing:
        print("timing " + json.dumps({"phases": TIMER.report()}))


if __name__ == "__main__":
    main()
