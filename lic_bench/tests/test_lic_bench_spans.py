"""The seven readers of the program's spans (`lic_bench/spans.py`) on
synthetic traces: nested program spans beside unrelated host events, in
and out of the traced window.  Each reads the expected host milliseconds
per traced pass, self time where it subtracts `codec.sync`; a run whose
program opens no such span reads None, and its result line leaves the
metric out."""

from __future__ import annotations

import pytest

from lic_bench import harness, run, spans
from lic_bench.reduce import Trace
from lic_bench.tests.tiny import ROOT, load

MS = 1_000_000  # ns


def _reading(host, passes, t0=0, t1=1000 * MS) -> harness.Reading:
    """A Reading whose trace holds `host` [(name, start ms, end ms)] and no
    device operation, over the window [t0, t1] ns."""
    tr = Trace.__new__(Trace)
    tr.t0, tr.t1, tr.window_s = t0, t1, (t1 - t0) / 1e9
    tr.kernels, tr.union, tr.busy_s = [], [], 0.0
    tr.host = [(n, int(s * MS), int(t * MS)) for n, s, t in host]
    return harness.Reading(trace=tr, spans={}, passes=passes,
                           window_s=51.0, windows=100)


def _bulk_pass(at):
    """One round trip's spans from `at` ms, with the host's own ops."""
    return [(n, at + s, at + t) for n, s, t in [
        ("codec.compress", 0, 100), ("codec.stage", 0, 5),
        ("aten::to", 1, 4), ("codec.replay", 10, 50),
        ("cudaGraphLaunch", 11, 49), ("codec.clone", 50, 52),
        ("codec.pack", 60, 100), ("codec.sync", 62, 90),
        ("aten::copy_", 62, 90),
        ("codec.decompress", 100, 300), ("codec.unpack", 100, 110),
        ("codec.stage", 110, 125), ("aten::pin_memory", 111, 124),
        ("codec.replay", 130, 160), ("codec.clone", 160, 161),
        ("codec.fetch", 200, 300), ("codec.sync", 201, 290)]]


def _request(at):
    return [(n, at + s, at + t) for n, s, t in [
        ("residual.compress", 0, 40), ("residual.vq_encode", 0, 3),
        ("aten::convolution", 1, 2), ("residual.reconstruct", 3, 5),
        ("codec.compress", 5, 30), ("codec.replay", 6, 16),
        ("codec.pack", 20, 30), ("codec.sync", 20, 28),
        ("residual.index_pack", 30, 40), ("codec.sync", 30, 39),
        ("residual.decompress", 40, 80), ("residual.index_unpack", 40, 41.5),
        ("residual.reconstruct", 41.5, 44), ("codec.decompress", 44, 70),
        ("codec.replay", 45, 57), ("codec.fetch", 70, 80),
        ("codec.sync", 70, 79)]]


def _train(at):
    return [(n, at + s, at + t) for n, s, t in [
        ("step.call", 0, 30), ("step.before", 0, 1), ("step.stage", 1, 2),
        ("step.replay", 2, 22), ("cudaGraphLaunch", 3, 21),
        ("step.clone", 22, 23), ("step.after", 23, 24)]]


def _read(name, r):
    return run.metric_reader(name).read(r)


def test_bulk_readers_per_round_trip():
    """Two round trips in the window and one half outside it: the
    replays (40 + 30 ms a pass), the staging (5 + 15), and the host's
    container coding less its syncs ((40 - 28) + 10 + (100 - 89))."""
    host = _bulk_pass(0) + _bulk_pass(300) + _bulk_pass(950)
    r = _reading(host, passes=2, t1=600 * MS)
    assert _read("launch_ms.bulk", r) == pytest.approx(70.0)
    assert _read("stage_ms.bulk", r) == pytest.approx(20.0)
    assert _read("pack_ms.bulk", r) == pytest.approx(33.0)
    # the third pass, cut at the window's end, counts only inside it
    r = _reading(host, passes=2, t1=1000 * MS)
    assert _read("launch_ms.bulk", r) == pytest.approx(70.0 + 40.0 / 2)


def test_request_readers_per_request():
    """Eight requests: replays 10 + 12 ms, the VQ-VAE 3 + 2 + 2.5, the
    index stream (10 - 9) + 1.5 less nothing else."""
    host = [e for i in range(8) for e in _request(100 * i)]
    r = _reading(host, passes=8)
    assert _read("launch_ms.request", r) == pytest.approx(22.0)
    assert _read("vq_ms.request", r) == pytest.approx(7.5)
    assert _read("index_ms.request", r) == pytest.approx(2.5)


def test_train_reader_per_call():
    host = _train(0) + _train(40)
    assert _read("launch_ms.train", _reading(host, passes=2)) == \
        pytest.approx(20.0)


def test_nested_names_count_once_and_self_time_subtracts_children():
    """A span nested in another of the names counts once (their union);
    `less` subtracts only the part its spans cover inside the names."""
    host = [("codec.fetch", 0, 10), ("codec.pack", 2, 4),
            ("codec.sync", 3, 6), ("codec.sync", 20, 30)]
    r = _reading(host, passes=1)
    assert spans.span_ms(r, ("codec.fetch", "codec.pack")) == \
        pytest.approx(10.0)
    assert spans.span_ms(r, ("codec.fetch",), less=("codec.sync",)) == \
        pytest.approx(7.0)
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10


NEW = ("launch_ms.bulk", "stage_ms.bulk", "pack_ms.bulk",
       "launch_ms.request", "vq_ms.request", "index_ms.request",
       "launch_ms.train")


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(name):
    """The parent program opens no span: its trace holds only torch's own
    host events (and spans outside the window), and each reader returns
    None, which the result line leaves out."""
    host = [("cudaGraphLaunch", 10, 50), ("aten::copy_", 60, 90),
            ("codec.replay", 1100, 1200), ("step.replay", 1100, 1200),
            ("residual.vq_encode", 1100, 1200)]
    r = _reading(host, passes=3)
    assert _read(name, r) is None
    bench = load(ROOT, "BENCHMARK.json")
    m, = [m for m in bench["per_layer"] if m["name"] == name]
    out = harness.Outcome(setup_s=1.0, reading=r)
    out.check({"x": 0.0}, {"x": 1.0})
    line = run.result_line(bench, m["workloads"][0], True, out, "cpu", 1)
    assert name not in line["metrics"] and line["correct"]
