"""The two new cells at a tiny size on the CPU: the two-level bulk driver
judges the port correct and a corrupted fine tile incorrect, the kernel's
FLOP count equals one built from the DenseLayer launches the port makes,
and the four-rank training cell's traffic runs on four gloo ranks.  Run
with `python -m pytest lic_bench/tests -q`."""

from __future__ import annotations

import time

import pytest
import torch

from lic_bench import harness, run
from lic_bench.dense_flops import dense_conv_flops
from lic_bench.drivers import train, twolevel_bulk
from lic_bench.reference.twolevel import arches
from lic_bench.tests.tiny import BENCH, ROOT, load, tiny_cell
from lic_bench.tests.tiny_twolevel import tiny_twolevel_model


def tiny_twolevel_cell(trace: bool = True) -> harness.Cell:
    """config_twolevel.bulk with the published model cut to 30x22 padded to
    32x24, a 4x3 rough flow and 8x8 tiles, two flows, DenseBlocks 8 x 2;
    queues of 2 batches of 2, 32 streams."""
    name = "config_twolevel.bulk"
    w = {x["name"]: x for x in load(ROOT, "BENCHMARK.json")["workloads"]}[
        name]
    config = load(BENCH, "configs", w["config"] + ".json")
    config["model"] = tiny_twolevel_model()
    config["num_streams"] = 32
    traffic = load(BENCH, "traffic", w["traffic"] + ".json")
    traffic.update(batch=2, queue=2, sample_from=2)
    return harness.Cell(name, config, traffic,
                        load(BENCH, "limits", name + ".json"), w["chips"],
                        2 ** 33 + 5, 0.5, trace, torch.device("cpu"),
                        time.perf_counter())


def test_twolevel_bulk_driver_round_trips_and_judges_correct():
    cell = tiny_twolevel_cell()
    out = twolevel_bulk.run(cell)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert out.e2e["roundtrip_images_per_s"] > 0
    for k in ("split_off_ppm", "container_symbols_off",
              "container_streams_bad", "roundtrip_images_bad"):
        assert out.checks[k][0] == 0, k
    assert out.notes["granularity"] == "level"
    r = out.reading
    assert r.windows >= 1 and r.extra["dense_flops_per_pass"] > 0
    assert run.metric_reader("pyramid_ms.twolevel").read(r) > 0
    # no device on the CPU: the kernel's roofline finds nothing to read
    assert run.metric_reader("conv_roofline_pct.twolevel").read(r) is None


def test_twolevel_bulk_driver_judges_a_corrupted_fine_tile_incorrect(
        monkeypatch):
    from finalproject_losslessimagecompression_tpu_torch.models import \
        twolevel

    real = twolevel.TwoLevelFlow.split_levels

    def corrupt(self, x):
        rx, px = real(self, x)
        px = px.clone()
        px[1, 3, 4, 2] += 1.0 / 256.0
        return rx, px

    monkeypatch.setattr(twolevel.TwoLevelFlow, "split_levels", corrupt)
    out = twolevel_bulk.run(tiny_twolevel_cell(trace=False))
    assert not out.correct
    assert out.checks["split_off_ppm"][0] > 0
    assert out.checks["roundtrip_images_bad"][0] > 0


def test_dense_flop_count_equals_the_ports_launch_shapes(monkeypatch):
    """The FLOPs `dense_flops` counts for a round trip equal 2 M g 9 cin
    summed over the DenseLayer launches the port makes in one (the buffer
    path forced on CPU tensors, where `dense_conv3x3` runs its plain
    version)."""
    from finalproject_losslessimagecompression_tpu_torch.models import layers
    from finalproject_losslessimagecompression_tpu_torch.models.twolevel_codec \
        import TwoLevelCodec

    cell = tiny_twolevel_cell()
    model = twolevel_bulk.program_model(cell, twolevel_bulk.weights(cell))
    seen = []
    real = layers.dense_conv3x3

    def record(buf, cin, w, bias_a, b3, slope):
        n, h, wd, _ = buf.shape
        seen.append(2 * n * h * wd * w.shape[-1] * 9 * cin)
        real(buf, cin, w, bias_a, b3, slope)

    monkeypatch.setattr(layers, "dense_conv3x3", record)
    monkeypatch.setattr(
        layers.DenseBlock, "grows_in_place",
        lambda self, x: self.kernel_fits and not torch.is_grad_enabled())
    codec = TwoLevelCodec(model, num_streams=32)
    m, t = cell.config["model"], cell.traffic
    xs = harness.batches(cell.seed, 0, t["queue"], t["batch"],
                         (m["H"], m["W"], 3))
    got = codec.decompress_many(codec.compress_many(xs), fetch=True)
    assert all((g == x).all() for g, x in zip(got, xs))
    ra, fa = arches(m)
    n = t["batch"] * t["queue"]
    # batches x directions x sub-flows x blocks (2 couplings, a prior) x
    # layers
    assert len(seen) == t["queue"] * 2 * 2 * 3 * 2
    assert sum(seen) == 2 * (dense_conv_flops(ra, n)
                             + dense_conv_flops(fa, n * 12))


def test_train4_traffic_steps_four_gloo_ranks_and_judges_correct():
    cell = tiny_cell("imagenet64.train4", trace=True)
    assert cell.chips == 4 and cell.traffic == dict(
        load(BENCH, "traffic", "train-dp.json"), batch=4)
    out = train.run(cell)
    assert out.correct, out.checks
    assert out.attempted % 4 == 0 and out.failed == 0
    assert out.reading.extra["ranks"] == 4
    # gloo runs no NCCL kernel: the collective reader finds nothing
    assert run.metric_reader("collective_device_ms").read(out.reading) is None


@pytest.mark.parametrize("name", ["conv_roofline_pct.twolevel",
                                  "pyramid_ms.twolevel",
                                  "collective_device_ms"])
def test_new_metrics_read_nothing_from_a_parent_without_them(name):
    """A traced reading with no kernel, span or rank of theirs: None."""
    r = harness.Reading(trace=type("T", (), {
        "host": [], "t0": 0, "t1": 1, "kernel_seconds":
        staticmethod(lambda match: 0.0)})(), spans={}, passes=2,
        window_s=1.0, windows=3)
    assert run.metric_reader(name).read(r) is None
