"""Bulk round trips: a closed loop of one client that compresses a queue
of batches with `FlowCodec.compress_many` and decompresses it with
`decompress_many(fetch=True)`, back to back, every image checked bit-exact
on the host.

Traffic keys: `batch` (images a batch), `queue` (batches a round trip),
`pool` (distinct queues drawn from the seed, cycled), `trace_passes`
(round trips under the profiler in a traced run), `sample_from` and
`sample_queues` (the window's round trips whose containers the comparison
reads, drawn from the seed among the first `sample_from`).  The end-to-end metric is `roundtrip_images_per_s`: the images
round-tripped in the window over its seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..judge import codec_numbers
from ..reduce import flow_flops, rans_bytes
from ..reference.flow import Flow, space_to_depth


def program_levels(model, x, cond=None):
    """The program's (z, keep, mean, logscale) per level on batch x (with
    its conditioning image), through its public model (`IDFlow.forward`
    gives no kept halves, so the levels are walked as its codec walks them,
    with the published squeeze)."""
    cfg, out = model.cfg, []
    with torch.no_grad():
        feats = (model.cond_features(cond) if cfg.conditional
                 else [None] * cfg.nsplit)
        for level, p in enumerate(model.plans):
            x = model.flow_level(space_to_depth(x, cfg.extend_scale), level)
            last = level == cfg.nsplit - 1
            z, keep = (x, None) if last else (x[..., :p.z_ch],
                                              x[..., p.z_ch:])
            mean, logscale = model.prior_params(z if last else keep, level,
                                                feats[level])
            out.append((z, keep, mean, logscale))
            x = keep
    return out


def run(cell: "harness.Cell") -> "harness.Outcome":
    from finalproject_losslessimagecompression_tpu_torch.models.exact import \
        FlowCodec

    t, dev = cell.traffic, cell.device
    a = cell.arch()
    model = cell.program_flow(cell.weights())
    codec = FlowCodec(model, num_streams=cell.config["num_streams"])
    size = (a.H, a.W, a.C)
    n_q = t["batch"] * t["queue"]
    pool = [harness.batches(cell.seed, q * n_q, t["queue"], t["batch"], size)
            for q in range(t["pool"])]
    # the window's round trips whose containers the comparison reads
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
    # second captures both directions' graphs; later calls replay
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
        shapes = harness.container_shapes(
            [blobs for q, blobs in kept.values()][0])
        trace = harness.traced(
            lambda: [round_trip(pool[i % len(pool)])
                     for i in range(t["trace_passes"])], dev)
        out.reading = harness.Reading(
            trace=trace, spans=spans, passes=t["trace_passes"],
            window_s=window, windows=passes,
            flops_per_pass=2 * flow_flops(a, n_q, backward=False),
            rans_bytes_per_pass=rans_bytes(shapes))
    out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    # the program's own latents and priors on the sampled queues: the key
    # that reads their containers
    judged = []
    for q, blobs in kept.values():
        for x, bl in zip(pool[q], blobs):
            xt = torch.as_tensor(x, device=dev)
            judged.append((xt, program_levels(model, xt), bl))
    del codec, model
    harness.free(dev)
    ref = Flow(a, cell.weights())
    nums = codec_numbers(
        ref, [x for x, _, _ in judged], [lv for _, lv, _ in judged],
        [bl for _, _, bl in judged])
    nums["roundtrip_images_bad"] = float(bad)
    out.check(nums, cell.limits)
    return out
