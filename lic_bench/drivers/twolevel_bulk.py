"""Bulk round trips through the two-level pyramid codec: a closed loop of
one client that compresses a queue of batches with
`TwoLevelCodec.compress_many` and decompresses it with
`decompress_many(fetch=True)`, back to back, every image checked
bit-exact on the host.  The codec runs at its default granularity, with
the configuration's `num_streams`.

The configuration is a published `TwoLevelFlows` entry (`model`): a rough
IDFlow over the pooled image and a fine IDFlow over the residual's tiles,
each with weights of its own drawn from the seed (streams ROUGH_STREAM
and FINE_STREAM of `data.seeded_weights`).

Traffic keys: `batch` (images a batch), `queue` (batches a round trip),
`pool` (distinct queues drawn from the seed, cycled), `trace_passes`
(round trips under the profiler in a traced run), `sample_from` and
`sample_queues` (the window's round trips whose containers the comparison
reads, drawn from the seed among the first `sample_from`).  The
end-to-end metric is `roundtrip_images_per_s`: the images round-tripped
in the window over its seconds.

The comparison (`twolevel_numbers`): the program's split of each sampled
batch (its public `split_levels`: rough image and tiles) against the
reference's (`split_off_ppm`: exact sums of grid values over powers of
two, so any difference is a fault), then `judge.codec_numbers` once per
sub-flow, the rough containers first: the containers read under the
program's priors, the latents from the reference's split, the priors.
The judged numbers are the sums (container counts) or the worst (ppm,
gap) over the two sub-flows; each sub-flow's own is a note.
"""

from __future__ import annotations

import copy
import importlib
import time

import numpy as np
import torch

from .. import harness
from ..data import seeded_weights
from ..dense_flops import dense_conv_flops
from ..judge import codec_numbers
from ..reference.flow import pin_float32
from ..reference.twolevel import TwoLevel, arches, shapes
from .bulk import program_levels

PKG = "finalproject_losslessimagecompression_tpu_torch"
ROUGH_STREAM, FINE_STREAM = 2, 3


def weights(cell) -> dict:
    """{"rough": ..., "fine": ...}: each sub-flow's weights from the
    seed, by the package's names without the sub-flow's prefix."""
    s = shapes(cell.config["model"])
    return {"rough": seeded_weights(s["rough"], cell.seed, cell.device,
                                    ROUGH_STREAM),
            "fine": seeded_weights(s["fine"], cell.seed, cell.device,
                                   FINE_STREAM)}


def program_model(cell, w: dict):
    """The program's TwoLevelFlow with the benchmark's weights loaded."""
    tl = importlib.import_module(PKG + ".models.twolevel")
    cfg = tl.TwoLevelCfg.from_ref(copy.deepcopy(cell.config["model"]))
    model = tl.TwoLevelFlow(cfg, device=cell.device, seed=cell.seed)
    model.load_state_dict({f"{part}.{k}": v for part in ("rough", "fine")
                           for k, v in w[part].items()}, strict=True)
    pin_float32()
    return model.eval()


def reference(cell, w: dict, precision: str = "float32") -> TwoLevel:
    return TwoLevel(cell.config["model"], w["rough"], w["fine"], precision)


def judged_side(model, x):
    """The program's split of batch x and each sub-flow's (z, keep, mean,
    logscale) per level on it, through its public model."""
    with torch.no_grad():
        rx, px = model.split_levels(x)
    return (rx, px), (program_levels(model.rough, rx),
                      program_levels(model.fine, px))


def twolevel_numbers(ref: TwoLevel, images, splits, levels, blobs=None):
    """images[b]: a batch (NHWC); splits[b]: the judged side's (rough
    image, tiles) of it; levels[b]: its (rough levels, fine levels);
    blobs[b]: its containers, the rough flow's first (None: a side that
    wrote none, such as the control)."""
    off = total = 0
    ref_splits = []
    for x, (rx, px) in zip(images, splits):
        r = ref.split(x)
        off += int((rx != r[0]).sum()) + int((px != r[1]).sum())
        total += r[0].numel() + r[1].numel()
        ref_splits.append(r)
    nr = ref.rough.a.nsplit
    out = {"split_off_ppm": off / max(total, 1) * 1e6}
    per = {}
    for i, (name, flow) in enumerate((("rough", ref.rough),
                                      ("fine", ref.fine))):
        bl = None if blobs is None else [b[:nr] if i == 0 else b[nr:]
                                         for b in blobs]
        per[name] = codec_numbers(flow, [s[i] for s in ref_splits],
                                  [lv[i] for lv in levels], bl)
    for k in per["rough"]:
        a, b = per["rough"][k], per["fine"][k]
        out[k] = a + b if k.startswith("container") else max(a, b)
    out.update({f"{k}.{name}": v for name, nums in per.items()
                for k, v in nums.items()})
    return out


def run(cell: "harness.Cell") -> "harness.Outcome":
    TwoLevelCodec = importlib.import_module(
        PKG + ".models.twolevel_codec").TwoLevelCodec
    t, dev, m = cell.traffic, cell.device, cell.config["model"]
    model = program_model(cell, weights(cell))
    codec = TwoLevelCodec(model, num_streams=cell.config["num_streams"])
    size = (m["H"], m["W"], m.get("C", 3))
    n_q = t["batch"] * t["queue"]
    pool = [harness.batches(cell.seed, q * n_q, t["queue"], t["batch"], size)
            for q in range(t["pool"])]
    rng = np.random.default_rng(np.random.SeedSequence([cell.seed, 1]))
    sample = set(int(i) for i in rng.choice(t["sample_from"],
                                            t["sample_queues"], False))

    def round_trip(queue):
        t0 = time.perf_counter()
        packed = codec.compress_many(queue)
        t1 = time.perf_counter()
        try:
            rec = codec.decompress_many(packed, fetch=True)
        except ValueError:  # a container that does not decode
            rec = [None] * len(queue)
        t2 = time.perf_counter()
        bad = sum(0 if r is not None and np.array_equal(r, x) else len(x)
                  for r, x in zip(rec, queue))
        return packed, bad, t1 - t0, t2 - t1

    # warm-up: the first call of the queue signature runs eagerly, the
    # second captures both sub-flows' graphs (on the card, fused); later
    # calls replay
    for i in range(2):
        round_trip(pool[i % len(pool)])
    out = harness.Outcome(setup_s=cell.elapsed())
    spans = {"compress": [], "decompress": []}
    kept = {}
    images = bad = passes = 0
    t_start = time.perf_counter()
    while True:
        q = passes % len(pool)
        packed, b, tc, td = round_trip(pool[q])
        spans["compress"].append(tc)
        spans["decompress"].append(td)
        if passes in sample or (not kept and
                                time.perf_counter() - t_start > cell.seconds):
            kept[passes] = (q, [blobs for blobs, _ in packed])
        images += n_q
        bad += b
        passes += 1
        if time.perf_counter() - t_start >= cell.seconds:
            break
    window = time.perf_counter() - t_start
    out.e2e["roundtrip_images_per_s"] = images / window
    out.attempted, out.failed = images, bad

    if cell.trace:
        ra, fa = arches(m)
        tiles = (m["H"] + m["pad"][0]) // fa.H * ((m["W"] + m["pad"][1])
                                                  // fa.W)
        trace = harness.traced(
            lambda: [round_trip(pool[i % len(pool)])
                     for i in range(t["trace_passes"])], dev)
        out.reading = harness.Reading(
            trace=trace, spans=spans, passes=t["trace_passes"],
            window_s=window, windows=passes,
            extra={"dense_flops_per_pass": 2 * (
                dense_conv_flops(ra, n_q) + dense_conv_flops(fa, n_q * tiles))
            })
    out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    out.notes.update({"granularity": codec.rough_codec.granularity, **{
        f"{name}.{k}": getattr(c, k) for name, c in (
            ("rough_codec", codec.rough_codec),
            ("fine_codec", codec.fine_codec))
        for k in ("captures", "replays", "eager_calls", "level_fallbacks")}})

    # the program's own split, latents and priors on the sampled queues:
    # the key that reads their containers
    xs, splits, levels, blobs = [], [], [], []
    for q, qblobs in kept.values():
        for x, bl in zip(pool[q], qblobs):
            xt = torch.as_tensor(x, device=dev)
            split, lv = judged_side(model, xt)
            xs.append(xt)
            splits.append(split)
            levels.append(lv)
            blobs.append(bl)
    del codec, model
    harness.free(dev)
    nums = twolevel_numbers(reference(cell, weights(cell)), xs, splits,
                            levels, blobs)
    nums["roundtrip_images_bad"] = float(bad)
    out.check(nums, cell.limits)
    return out
