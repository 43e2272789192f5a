"""Program spans (`utils.profiling.span`) and the counters beside them.

On the CPU, under a torch.profiler CPU profile: every span a FlowCodec,
a ResidualCodec and a GraphedStep open appears on the profiler's timeline,
nests under its call's top-level span and inside the enclosing
`record_function` window, and the count of each counted span equals its
counter's change.  The card's graph path runs here with stub graphs (the
card's call sequence: an eager first call, a capture, replays), as in
test_torch_granularity and test_torch_step.  With no profiler and no
collecting PhaseTimer a span enters nothing.  `profile_busy`'s busy time
is the union of the device intervals over its window.
"""

from __future__ import annotations

import collections
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch.models.vqvae import (
    build_vqvae_from_ref,
)
from finalproject_losslessimagecompression_tpu_torch.utils import profiling
from finalproject_losslessimagecompression_tpu_torch.utils.graphs import (
    GraphedStep,
)
from test_torch_graphs import stub_graphs

WINDOW = "test.window"
PREFIXES = ("codec.", "residual.", "step.")
CODEC_SPANS = {
    "codec.compress", "codec.decompress", "codec.unpack", "codec.stage",
    "codec.replay", "codec.eager", "codec.capture", "codec.evict",
    "codec.level_fallback", "codec.clone", "codec.pack", "codec.fetch",
    "codec.sync"}
RESIDUAL_SPANS = {
    "residual.compress", "residual.decompress", "residual.vq_encode",
    "residual.reconstruct", "residual.index_pack", "residual.index_unpack"}
STEP_SPANS = {"step.call", "step.before", "step.after", "step.stage",
              "step.replay", "step.eager", "step.capture", "step.clone"}
# counted span -> the counter of the same event
CODEC_COUNTED = {"codec.capture": "captures", "codec.replay": "replays",
                 "codec.eager": "eager_calls", "codec.evict": "evictions",
                 "codec.level_fallback": "level_fallbacks"}
STEP_COUNTED = {"step.capture": "captures", "step.replay": "replays",
                "step.eager": "eager_calls"}

VQ_DICT = dict(
    name="VQVAE", channel=3, embed_num=16, embed_dim=8, hidden_dims=[8, 16],
    encoder=dict(name="VQEncoder", block_num=1,
                 block=dict(name="ResBlock", batch_norm=False)),
    decoder=dict(name="VQDecoder", block_num=1,
                 block=dict(name="ResBlock", batch_norm=False)),
    distribution=dict(name="BinomialDistribution"),
    vectorquantizer=dict(reinit_interval=1000, threshold=0.1),
)


def _cond_flow_dict():
    nn = dict(name="DenseBlock", growth_channel=8, depth=2,
              layer=dict(name="DenseLayer", act="LeakyReLU"))
    return dict(
        name="ConditionalFlows", nflows=2, nbits=8, nsplit=2, H=8, W=8, C=3,
        couple=dict(name="AdditiveCouple", split=0.75, nn=nn,
                    round=dict(name="Round", nbits=8)),
        extenddim=dict(name="ExtendDim", scale=2),
        prior=dict(name="Prior", round=dict(name="Round", nbits=8), nn=nn),
        distribution=dict(name="DLogistic"),
        round=dict(name="Round", nbits=8),
        conv_for_cond=True,
    )


def _images(seed, batch=2, size=16):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(0, 1, (batch, size, size, 3)) * 256)
            / 256).astype(np.float32)


def _flow():
    nn = TM.DenseBlockCfg(8, 2, "ReLU")
    cfg = TM.FlowCfg(H=16, W=16, C=3, nflows=2, nsplit=2,
                     couple=TM.CouplingCfg(0.75, nn), prior_nn=nn)
    return TM.IDFlow(cfg, device="cpu").eval()


def _profiled(fn):
    """(fn(), [(name, start ns, end ns)] of the program spans and of the
    window) under a CPU profile whose window is a record_function."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            out = fn()
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() == WINDOW or e.name().startswith(PREFIXES)]
    return out, events


def _check_nesting(events, top):
    """Every program span lies inside the window and inside one of the
    top-level spans `top`; the top-level spans nest in no program span."""
    (w0, w1), = [(s, t) for n, s, t in events if n == WINDOW]
    spans = [(n, s, t) for n, s, t in events if n != WINDOW]
    tops = [(s, t) for n, s, t in spans if n in top]
    assert tops
    for n, s, t in spans:
        assert w0 <= s <= t <= w1, n
        if n not in top:
            assert any(a <= s and t <= b for a, b in tops), n
    for n, s, t in spans:
        if n in top:
            assert not any(a <= s and t <= b and (a, b) != (s, t)
                           for m, a, b in spans if m in top), n
    return collections.Counter(n for n, _, _ in spans)


def _counters(obj, counted):
    return {k: getattr(obj, v) for k, v in counted.items()}


def test_flow_codec_spans_on_the_profilers_timeline():
    """A FlowCodec on the card's path (stub graphs, MAX_GRAPHS 1): first
    sight eager, a capture and replay per direction, the decompress graph
    evicting the compress one, a pure replay, and a queue with escapes
    past MAX_OUTLIERS decoded by level.  Every codec span appears, nests
    under `codec.compress` or `codec.decompress` inside the window, each
    round trip is exact, and each counted span's count equals its
    counter's change."""
    codec = TM.FlowCodec(_flow(), num_streams=64, granularity="fused")
    stub_graphs(codec.graph_cache)
    codec.graph_cache.MAX_GRAPHS = 1
    xs = [_images(1)]
    wild = _images(2)
    wild[:, ::3, ::3, 0] += 40.0  # far outside any prior's window

    def run():
        outs = []
        for _ in range(2):  # eager, then captured and replayed
            packed = codec.compress_many(xs)
            outs.append(codec.decompress_many(packed, fetch=True))
        outs.append(codec.decompress_many(packed, fetch=True))  # replayed
        codec.MAX_OUTLIERS = 0
        outs.append(codec.decompress_many(codec.compress_many([wild]),
                                          fetch=True))
        return outs

    before = _counters(codec, CODEC_COUNTED)
    outs, events = _profiled(run)
    for got, want in zip(outs, [xs, xs, xs, [wild]]):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    counts = _check_nesting(events, {"codec.compress", "codec.decompress"})
    assert set(counts) == CODEC_SPANS
    after = _counters(codec, CODEC_COUNTED)
    assert {k: after[k] - before[k] for k in after} == {
        k: counts[k] for k in CODEC_COUNTED}
    assert (codec.captures, codec.evictions, codec.level_fallbacks) == (
        2, 1, 1)
    assert counts["codec.replay"] == 3 and counts["codec.clone"] == 3


def test_residual_request_spans_nest_under_the_request():
    """A ResidualCodec request (compress_many, decompress_many with fetch)
    opens every residual span, each under `residual.compress` or
    `residual.decompress`, the flow's `codec.compress` and
    `codec.decompress` among them; the reconstruction runs once a
    direction, the index copy is a `codec.sync` inside
    `residual.index_pack`; the request round-trips exactly."""
    vq = build_vqvae_from_ref(VQ_DICT, device="cpu").eval()
    flow = TM.IDFlow(TM.FlowCfg.from_ref(_cond_flow_dict()),
                     device="cpu").eval()
    codec = TM.ResidualCodec(vq, TM.FlowCodec(flow, num_streams=32),
                             (16, 16))
    x = _images(3)
    got, events = _profiled(lambda: codec.decompress_many(
        codec.compress_many([x]), fetch=True))
    assert np.array_equal(got[0], x)
    counts = _check_nesting(events, {"residual.compress",
                                     "residual.decompress"})
    assert RESIDUAL_SPANS <= set(counts)
    assert {"codec.compress", "codec.decompress", "codec.pack",
            "codec.fetch", "codec.sync"} <= set(counts)
    assert counts["residual.reconstruct"] == 2
    (a, b), = [(s, t) for n, s, t in events if n == "residual.index_pack"]
    assert any(a <= s and t <= b for n, s, t in events if n == "codec.sync")
    assert counts["codec.eager"] == codec.codec.eager_calls == 2


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "stub"])
def test_graphed_step_spans_equal_its_counters(graphs):
    """A GraphedStep's calls open `step.call` each, `step.before` and
    `step.after` around them; with graphs off every call is `step.eager`;
    on the card's path (stub graphs) the first call is eager, the second
    captures, and the second and later replay, each replay with its
    `step.stage` and `step.clone`.  Each counted span's count equals its
    counter."""
    w = torch.zeros(3)
    seen = []
    step = GraphedStep(lambda x: w.add_(x) * 1.0, "cpu", graphs=False,
                       before=lambda x: seen.append("before"),
                       after=lambda: seen.append("after"))
    if graphs:
        stub_graphs(step.cache)
    calls = 4
    _, events = _profiled(lambda: [step(torch.ones(3)) for _ in
                                   range(calls)])
    counts = _check_nesting(events, {"step.call"})
    assert counts["step.call"] == counts["step.before"] == \
        counts["step.after"] == calls and len(seen) == 2 * calls
    assert {k: counts[k] for k in STEP_COUNTED} == _counters(
        step, STEP_COUNTED)
    if graphs:
        assert set(counts) == STEP_SPANS
        assert (step.eager_calls, step.captures, step.replays) == (1, 1, 3)
        assert counts["step.stage"] == counts["step.clone"] == 3
    else:
        assert set(counts) == {"step.call", "step.before", "step.after",
                               "step.eager"}
        assert step.eager_calls == calls


def test_spans_enter_nothing_without_a_profiler_or_timer(monkeypatch):
    """With no profiler recording and no PhaseTimer collecting, a span is
    one shared null context and no record_function is entered: a codec
    round trip and a step's calls run with record_function raising."""

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b")
    codec = TM.FlowCodec(_flow(), num_streams=64, granularity="fused")
    stub_graphs(codec.graph_cache)
    xs = [_images(4)]
    for _ in range(3):
        got = codec.decompress_many(codec.compress_many(xs), fetch=True)
        assert np.array_equal(got[0], xs[0])
    assert (codec.captures, codec.replays) == (2, 4)
    step = GraphedStep(lambda x: x * 2.0, "cpu", graphs=False)
    assert torch.equal(step(torch.ones(2)), torch.full((2,), 2.0))
    with pytest.raises(AssertionError, match="record_function"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("a"):
                pass


def test_phase_timer_collects_its_phases_and_the_spans_inside():
    """PhaseTimer.phase still accumulates (on perf_counter), counts each
    entry, and while a phase is open the timer collects every span opened
    inside it under that span's name; a span outside any phase is the
    null context again.  Under a profiler a phase is a record_function
    range like any span."""
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer.phase("encode"):
            with profiling.span("codec.pack"):
                with profiling.span("codec.sync"):
                    pass
    with timer.phase("decode"):
        with timer.phase("decode:inner"):
            pass
    assert dict(timer.counts) == {"encode": 2, "codec.pack": 2,
                                  "codec.sync": 2, "decode": 1,
                                  "decode:inner": 1}
    assert timer.totals["encode"] >= timer.totals["codec.pack"] >= \
        timer.totals["codec.sync"] >= 0.0
    assert profiling.span("x") is profiling.span("y")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("forward"):
            pass
    assert "forward" in {e.name()
                         for e in prof.profiler.kineto_results.events()}
    assert timer.counts["forward"] == 1


def test_profile_busy_counts_overlapping_device_intervals_once():
    """Busy time is the union of the device intervals inside the window
    (`profile_busy`'s arithmetic): two overlapping kernels count once,
    a user annotation and the host's events not at all, and time outside
    the window is cut off.  The old sum of kernel times read the device
    80% busy where it was busy 60% of the window."""
    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, s, t, dev=cuda, annotation=False):
        return SimpleNamespace(
            name=lambda: name, start_ns=lambda: s, end_ns=lambda: t,
            device_type=lambda: dev, is_user_annotation=lambda: annotation)

    events = [
        ev(profiling.PROFILED_WINDOW, 100, 300, torch.autograd.DeviceType.CPU),
        ev("kernel_a", 100, 160), ev("kernel_b", 140, 190),  # overlap 20
        ev("copy", 250, 270), ev("late", 290, 320),  # 10 past the window
        ev("annotation", 100, 300, annotation=True),
        ev("host_op", 100, 300, torch.autograd.DeviceType.CPU),
        ev("empty", 200, 200)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t0, t1 = profiling.host_window(prof, profiling.PROFILED_WINDOW)
    assert (t0, t1) == (100, 300)
    ivs = profiling.device_intervals(prof)
    assert len(ivs) == 4
    busy = profiling.busy_seconds(ivs, t0, t1)
    assert busy == pytest.approx(120e-9)
    kernel_sum = sum(us for _, us, _ in profiling.kernel_times(prof)) / 1e6
    assert kernel_sum == pytest.approx(160e-9)  # what the old busy time read
    assert 1.0 - busy / ((t1 - t0) / 1e9) == pytest.approx(0.4)
    assert profiling.busy_seconds([(0, 10), (5, 15), (20, 30)], 0, 40) \
        == pytest.approx(25e-9)
    assert profiling.busy_seconds([(0, 50), (10, 20)], 0, 40) == \
        pytest.approx(40e-9)
