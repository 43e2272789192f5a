"""Serving-path roofline: one flagship queue pass's time attributed between
the flow NN and the rANS coder, a stream-count sweep, and a bfloat16
serving probe.  The counterpart of the repository's
`demo/run_serving_roofline_r05.py`.

Each term is the median of `--iters` runs over the queue, fenced with
`torch.cuda.synchronize()`:

    nn_fwd            flows and priors forward (`IDFlow.forward`) over
                      every batch: the NN side of compress;
    nn_inv            prior regeneration and inverse flows (`prior_params`,
                      `flow_level_inverse`, levels nsplit-1 .. 0) over
                      every batch: the NN side of decompress, returning the
                      priors' sum so that nothing is dead; it must
                      reconstruct the forward input exactly;
    rans_enc          the encode kernels alone (prepass and state chain)
                      at each level's (S, k), the queue's containers of a
                      level in one launch as the pipeline codes them, on
                      the model's latents, means and scales;
    rans_dec          the decode kernel alone likewise, checked exact;
    compress_total    the fused compress pipeline (a replayed CUDA graph,
    decompress_total  without the pack), and the fused decompress.

The attribution closes where nn + rans ~= total per direction; the
residual is the glue (rounding, reshapes, bits-back seeds, uploads).

The sweep codes the queue through codecs asking for 4096, 8192 and 16384
streams and records each level's effective stream count
(`pick_num_streams` caps it at the level's symbols per stream); an
effective count the kernels cannot take raises (`check_streams`).  The
bf16 probe runs the same float32 weights through the bfloat16 conv stack;
a failure fails the run.

    python -m finalproject_losslessimagecompression_tpu_torch.demo.serving_roofline \\
        [--batch 16] [--queue 4] [--iters 5] [--streams 4096,8192,16384] \\
        [--quick] [--device cpu] [--out results/torch_h100/serving_roofline.json]
"""

from __future__ import annotations

import argparse
import gc
import statistics

import numpy as np
import torch

from .. import bench
from ..codec import interleaved as IL
from ..codec.cuda_rans import check_streams, rans_decode, rans_encode
from ..models.exact import FlowCodec
from ..models.idflow import resolve_device
from ..ops.reshape import depth_to_space
from ..utils.profiling import device_label
from . import write_new


def _median(fn, iters: int, device):
    """(fn()'s last result, median seconds of `iters` fenced runs after
    one run that is not timed)."""
    secs, out = [], fn()
    for _ in range(iters):
        out, sec = bench._timed(fn, device)
        secs.append(sec)
    return out, statistics.median(secs)


@torch.no_grad()
def nn_inverse(model, latents):
    """Regenerate every prior and invert the flows from exact latents, as
    the decompress pipeline does without its rANS decode: (the input, the
    sum of every prior's outputs)."""
    cfg, x = model.cfg, None
    acc = torch.zeros((), device=latents[0].device)
    for level in range(cfg.nsplit - 1, -1, -1):
        last = level == cfg.nsplit - 1
        z = latents[level]
        mean, logscale = model.prior_params(z if last else x, level)
        acc = acc + mean.sum() + logscale.sum()
        xi = z if last else torch.cat([z, x], dim=-1)
        x = depth_to_space(model.flow_level_inverse(xi, level),
                           cfg.extend_scale)
    return x, acc


def level_messages(codec, outs):
    """Per level, the queue's prepared [C, k, S] tiles (window-clamped
    bins, means, scales, lower bounds) of the model outputs `outs` (one
    (latents, means, logscales) per batch), at the codec's (S, k)."""
    msgs = []
    for level in range(codec.cfg.nsplit):
        tiles = []
        for lat, means, logscales in outs:
            v = torch.round(lat[level] * 256.0).to(torch.int32).reshape(-1)
            n = v.numel()
            S = codec._level_S(level, lat[level].shape[0])
            k = IL._plan_steps(n, S)
            tiles.append(IL._prepare_encode(
                v, means[level].reshape(-1),
                torch.exp(logscales[level]).reshape(-1), S, k)[:4])
        msgs.append(tuple(torch.stack(t) for t in zip(*tiles)))
    return msgs


def rans_pair(msgs):
    """The encode kernels, then compaction and the decode kernel, at every
    level: (encodes, decoded values per level), each decode checked to
    return its level's bins."""
    encs = [rans_encode(*m) for m in msgs]
    vals = []
    for (vc, mk, sk, lower), (words, flags, hi, lo) in zip(msgs, encs):
        buf, total = IL.compact(words, flags)
        v, _, _ = rans_decode(buf, total, hi, lo, mk, sk, lower)
        if not torch.equal(v, vc):
            raise AssertionError("rANS decode did not return the bins")
        vals.append(v)
    return encs, vals


def _pass(codec, xs, xs_np, iters, device):
    """Warm a codec on the queue (eager, capture), check a round trip
    exact, then time `iters` fenced compress + decompress replays:
    (seconds, real bpd)."""
    for _ in range(2):
        packed, recs = bench._round_trip(codec, xs)
    if not bench._exact(recs, xs_np):
        raise AssertionError("serving round trip is not bit-exact")

    def run():
        codec.encode_queue(xs)
        return codec.decode_queue(packed)

    _, sec = _median(run, iters, device)
    return sec, float(np.mean([codec.real_bpd(b, i) for b, i in packed]))


def run(batch: int = 16, queue: int = 4, iters: int = 5,
        streams=(4096, 8192, 16384), quick: bool = False,
        device=None) -> dict:
    device = resolve_device(device)
    cfg, model = bench.build_model(quick, bf16=False, device=device)
    xs = bench.batches(batch, queue, device=device)
    xs_np = [x.cpu().numpy() for x in xs]
    n_img = batch * queue

    with torch.no_grad():
        outs, t_nn_fwd = _median(lambda: [model(x) for x in xs], iters,
                                 device)
    invs, t_nn_inv = _median(lambda: [nn_inverse(model, lat)
                                      for lat, _, _ in outs], iters, device)
    nn_exact = all(torch.equal(x, r) for x, (r, _) in zip(xs, invs))
    if not nn_exact:
        raise AssertionError("NN inverse does not reconstruct the input")

    codec = FlowCodec(model, num_streams=bench.CODEC_STREAMS,
                      granularity="fused")
    msgs = level_messages(codec, outs)
    rans_pair(msgs)  # warm-up and check
    _, t_rans_enc = _median(lambda: [rans_encode(*m) for m in msgs], iters,
                            device)
    pre = [IL.compact(w, f) + (hi, lo)
           for w, f, hi, lo in (rans_encode(*m) for m in msgs)]
    _, t_rans_dec = _median(
        lambda: [rans_decode(buf, tot, hi, lo, mk, sk, lower)
                 for (buf, tot, hi, lo), (_, mk, sk, lower) in zip(pre,
                                                                   msgs)],
        iters, device)
    rans_shapes = [[int(m[0].shape[-1]), int(m[0].shape[-2]), False]
                   for m in msgs]  # [S, k, seeded]: no bits-back seeds
    del pre

    for _ in range(2):  # eager, then the capture
        packed, recs = bench._round_trip(codec, xs)
    if not bench._exact(recs, xs_np):
        raise AssertionError("fused round trip is not bit-exact")
    _, t_comp_total = _median(lambda: codec.encode_queue(xs),
                              iters, device)
    _, t_dec_total = _median(lambda: codec.decode_queue(packed),
                             iters, device)
    del msgs

    sweep = {}
    for S0 in streams:
        # the attribution's codec (its graphs captured) where it asks for
        # these streams
        c2 = codec if S0 == codec.num_streams else FlowCodec(
            model, num_streams=S0, granularity="fused")
        eff = [c2._level_S(level, batch) for level in range(cfg.nsplit)]
        for S in eff:
            check_streams(S)
        sec, bpd = _pass(c2, xs, xs_np, iters, device)
        sweep[str(S0)] = {"roundtrip_device_s": sec,
                          "imgs_per_s": n_img / sec, "real_bpd": bpd,
                          "effective_level_streams": eff,
                          "bit_exact": True}
        print("num_streams", S0, sweep[str(S0)], flush=True)
        del c2
        gc.collect()
    del codec

    # the same float32 weights through the bfloat16 conv stack
    _, bmodel = bench.build_model(quick, bf16=True, device=device)
    bmodel.load_state_dict(model.state_dict())
    cb = FlowCodec(bmodel, num_streams=bench.CODEC_STREAMS,
                   granularity="fused")
    sec, bpd = _pass(cb, xs, xs_np, iters, device)
    bf16_probe = {"roundtrip_device_s": sec, "imgs_per_s": n_img / sec,
                  "real_bpd": bpd, "bit_exact": True}
    print("bf16 probe", bf16_probe, flush=True)
    del cb, bmodel
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    return {
        "what": "serving-path roofline: time attribution between the flow "
                f"NN and rANS for one queue pass ({n_img} images, "
                f"{'quick' if quick else 'flagship'} model, seeded weights "
                "with perturbed projections), medians of runs fenced with "
                "synchronize",
        "device": device_label(device),
        "batch": batch, "queue": queue, "iters": iters,
        "phases_s": {
            "nn_fwd": t_nn_fwd, "nn_inv": t_nn_inv,
            "rans_enc": t_rans_enc, "rans_dec": t_rans_dec,
            "compress_total": t_comp_total,
            "decompress_total": t_dec_total,
        },
        "attribution": {
            "encode_nn_plus_rans_s": t_nn_fwd + t_rans_enc,
            "decode_nn_plus_rans_s": t_nn_inv + t_rans_dec,
            "encode_residual_s": t_comp_total - t_nn_fwd - t_rans_enc,
            "decode_residual_s": t_dec_total - t_nn_inv - t_rans_dec,
        },
        "rans_level_shapes": rans_shapes,
        "stream_sweep": sweep,
        "bf16_serving_probe": bf16_probe,
        "nn_inverse_reconstructs": nn_exact,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--queue", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--streams", default="4096,8192,16384")
    ap.add_argument("--quick", action="store_true",
                    help="the small model (a CPU run of the harness)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                    "the CPU)")
    ap.add_argument("--out", default=None,
                    help="a new JSON file for the result")
    args = ap.parse_args(argv)
    out = run(args.batch, args.queue, args.iters,
              [int(s) for s in args.streams.split(",") if s], args.quick,
              args.device)
    print({k: out[k] for k in ("phases_s", "attribution")})
    if args.out:
        write_new(args.out, out)
    return out


if __name__ == "__main__":
    main()
