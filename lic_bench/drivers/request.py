"""On-demand requests to the residual codec, in a closed loop of one
client: each request is sent as soon as the last one has come back.  A
request is one batch, `ResidualCodec.compress_many([x])` then
`decompress_many(..., fetch=True)`, every image checked bit-exact on the
host.  The VQ-VAE runs eagerly each way; the conditional flow's two
directions replay one CUDA graph each.

Traffic keys: `batch` (images a request), `pool` (distinct requests drawn
from the seed, cycled), `sample_from` and `sample_requests` (the window's
requests whose containers the comparison reads, drawn from the seed; the
index streams of every distinct request served are read; the window
serves at least `sample_from`), `trace_requests` (requests served back to
back under the profiler in a traced run).  The end-to-end metric is
`request_p95_ms`: the 95th percentile, over every request of the window,
of the time from the call to the decompressed image on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..judge import residual_numbers
from ..reduce import flow_flops, vq_flops
from ..reference.flow import Flow
from ..reference.vqvae import VQVAE, unpack_indices
from .bulk import program_levels


def program_rec(vq, idx, nbits: int):
    """The program's conditioning image of indices, through its public
    VQ-VAE (the codec's formula: decode(codebook[idx]) / 2 + 1/2 on the
    grid)."""
    with torch.no_grad():
        rec = vq.decode(vq.vq.codebook[idx]) * 0.5 + 0.5
        return torch.round(rec * 2.0 ** nbits) / 2.0 ** nbits


def run(cell: "harness.Cell") -> "harness.Outcome":
    from finalproject_losslessimagecompression_tpu_torch.models.exact import \
        FlowCodec
    from finalproject_losslessimagecompression_tpu_torch.models import \
        residual_codec

    t, c, dev = cell.traffic, cell.config, cell.device
    a = cell.arch()
    model = cell.program_flow(cell.weights())
    vq = cell.program_vqvae(cell.vq_weights())
    size = tuple(c["input_size"]) + (a.C,)
    codec = residual_codec.ResidualCodec(
        vq, FlowCodec(model, c["num_streams"]), tuple(c["input_size"]))
    pool = harness.batches(cell.seed, 0, t["pool"], t["batch"], size)
    rng = np.random.default_rng(np.random.SeedSequence([cell.seed, 1]))
    sample = set(int(i) for i in rng.choice(t["sample_from"],
                                            t["sample_requests"], False))

    def request(x):
        t0 = time.perf_counter()
        packed = codec.compress_many([x])
        t1 = time.perf_counter()
        try:
            rec = codec.decompress_many(packed, fetch=True)[0]
        except ValueError:  # a container that does not decode
            rec = None
        t2 = time.perf_counter()
        bad = 0 if rec is not None and np.array_equal(rec, x) else len(x)
        return packed[0], bad, t1 - t0, t2 - t1

    for i in range(2):  # eager, then the flow's graphs captured
        request(pool[i % len(pool)])
    out = harness.Outcome(setup_s=cell.elapsed())
    spans = {"compress": [], "decompress": [], "request": []}
    kept, streams = {}, {}
    bad = n = 0
    t_start = time.perf_counter()
    while n < t["sample_from"] or \
            time.perf_counter() - t_start < cell.seconds:
        q = n % len(pool)
        (idx_blob, blobs, _), b, tc, td = request(pool[q])
        spans["compress"].append(tc)
        spans["decompress"].append(td)
        spans["request"].append(tc + td)
        streams.setdefault(q, idx_blob)
        if n in sample:
            kept[n] = (q, blobs)
        bad += b
        n += 1
    window = time.perf_counter() - t_start
    out.e2e["request_p95_ms"] = float(np.percentile(spans["request"], 95)
                                      * 1e3)
    out.attempted, out.failed = n * t["batch"], bad

    if cell.trace:
        trace = harness.traced(
            lambda: [request(pool[i % len(pool)])
                     for i in range(t["trace_requests"])], dev)
        vq_f = vq_flops(c["vqvae"], t["batch"], c["input_size"])
        flow_f = flow_flops(a, t["batch"], backward=False)
        out.reading = harness.Reading(
            trace=trace, spans=spans, passes=t["trace_requests"],
            window_s=window, windows=n,
            flops_per_pass=2 * flow_f + vq_f["encoder"] + 2 * vq_f["decoder"]
            + vq_f["codebook"])
    out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    # the program's indices (as its index streams carry them), its
    # reconstructions, and on the sampled requests its flow's latents and
    # priors: the key that reads their containers
    xs = {q: torch.as_tensor(pool[q], device=dev) for q in streams}
    idxs = {q: torch.as_tensor(unpack_indices(b), device=dev)
            for q, b in streams.items()}
    recs = {q: program_rec(vq, i, a.nbits) for q, i in idxs.items()}
    sampled = [(xs[q], recs[q], program_levels(model, xs[q] - recs[q],
                                               recs[q]), blobs)
               for q, blobs in kept.values()]
    del codec, model, vq
    harness.free(dev)
    nums = residual_numbers(
        VQVAE(c["vqvae"], cell.vq_weights()), Flow(a, cell.weights()),
        list(xs.values()), list(idxs.values()), list(recs.values()), sampled)
    nums["roundtrip_images_bad"] = float(bad)
    out.check(nums, cell.limits)
    return out
