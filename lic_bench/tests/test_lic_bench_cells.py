"""Every driver end to end at the tiny size on the CPU, the reference
against the package under test on seeded weights, and the frozen FLOP
count against the package's own.  Run with
`python -m pytest lic_bench/tests -q`."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from lic_bench import harness, run
from lic_bench.drivers import bulk, request, train
from lic_bench.data import seeded_weights
from lic_bench.judge import codec_numbers
from lic_bench.reduce import flow_flops
from lic_bench.reference.flow import Flow, arch, param_shapes
from lic_bench.reference.train import PlainTrainer
from lic_bench.tests.tiny import load, tiny_cell, tiny_config, BENCH

PKG = "finalproject_losslessimagecompression_tpu_torch"


def test_bulk_driver_round_trips_and_judges_correct():
    cell = tiny_cell("imagenet64.bulk", trace=True)
    out = bulk.run(cell)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert out.e2e["roundtrip_images_per_s"] > 0
    assert out.checks["container_symbols_off"][0] == 0
    assert out.checks["container_streams_bad"][0] == 0
    r = out.reading
    assert r.windows >= 1 and r.flops_per_pass > 0
    assert r.rans_bytes_per_pass > 0
    assert run.metric_reader("compress_ms.bulk").read(r) > 0
    assert run.metric_reader("serve_mfu_pct.bulk").read(r) > 0
    # no device on the CPU: the device readers find nothing to read
    assert run.metric_reader("conv_roofline_pct.bulk").read(r) is None


def test_train_driver_steps_and_judges_correct():
    cell = tiny_cell("imagenet64.train", trace=True)
    out = train.run(cell)
    assert out.correct, out.checks
    assert out.attempted % 4 == 0 and out.failed == 0
    assert out.e2e["train_images_per_s"] > 0
    assert run.metric_reader("train_mfu_pct").read(out.reading) > 0


def test_request_driver_serves_a_closed_loop_and_judges_correct():
    cell = tiny_cell("resflow-cond-imagenet64.request", trace=True)
    out = request.run(cell)
    assert out.correct, out.checks
    r = out.reading
    n = len(r.spans["request"])
    # one client: a request is its two calls, back to back
    assert n == r.windows >= cell.traffic["sample_from"]
    assert out.attempted == n * cell.traffic["batch"] and out.failed == 0
    assert r.spans["request"] == [
        c + d for c, d in zip(r.spans["compress"], r.spans["decompress"])]
    assert out.e2e["request_p95_ms"] == pytest.approx(
        1e3 * np.percentile(r.spans["request"], 95))
    # the whole request's share of the peak over the seconds it was served
    mfu = run.metric_reader("serve_mfu_pct.request").read(r)
    assert mfu == pytest.approx(100 * r.flops_per_pass * n / (
        sum(r.spans["request"]) * 67e12))


def test_reference_flow_matches_the_port_on_seeded_weights():
    from finalproject_losslessimagecompression_tpu_torch.models.config \
        import FlowCfg
    from finalproject_losslessimagecompression_tpu_torch.models.idflow \
        import IDFlow

    cfg = tiny_config()
    a = arch(cfg["model"])
    cell = tiny_cell("imagenet64.bulk")
    w = cell.weights()
    model = IDFlow(FlowCfg.from_ref(cfg["model"]), device="cpu", seed=0)
    model.load_state_dict(w, strict=True)
    x = torch.as_tensor(harness.batches(5, 0, 1, 8, (a.H, a.W, a.C))[0])
    with torch.no_grad():
        lat, means, logs = model(x)
        ref = Flow(a, w).forward(x)
    for (z, _, m, ls), zp, mp, lp in zip(ref, lat, means, logs):
        assert torch.equal(z, zp)
        torch.testing.assert_close(m, mp, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(ls, lp, rtol=1e-4, atol=1e-5)
    nums = codec_numbers(Flow(a, w), [x], [bulk.program_levels(model, x)])
    assert nums["latents_off_ppm"] == 0 and nums["prior_gap"] < 1e-4


def test_reference_train_step_matches_the_port():
    from finalproject_losslessimagecompression_tpu_torch.models.config \
        import FlowCfg
    from finalproject_losslessimagecompression_tpu_torch.models.idflow \
        import IDFlow
    from finalproject_losslessimagecompression_tpu_torch.train.optim import \
        build_optimizer
    from finalproject_losslessimagecompression_tpu_torch.train.trainer import \
        make_train_step

    cfg = tiny_config()
    a = arch(cfg["model"])
    w = tiny_cell("imagenet64.train").weights()
    model = IDFlow(FlowCfg.from_ref(cfg["model"]), device="cpu", seed=0)
    model.load_state_dict(w, strict=True)
    opt = build_optimizer(model.parameters(), cfg["optimizer"],
                          cfg["scheduler"], cfg["step_per_epoch"])
    step, _ = make_train_step(model, opt)
    ref = PlainTrainer(a, w, cfg["optimizer"], cfg["scheduler"],
                       cfg["step_per_epoch"])
    for i in range(3):
        x = torch.as_tensor(harness.batches(9, 4 * i, 1, 4,
                                            (a.H, a.W, a.C))[0])
        loss, _ = step(x)
        assert float(loss) == pytest.approx(ref.step(x), rel=1e-5)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), ref.params[name].detach(),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("config", ["imagenet64", "tiny"])
def test_frozen_flop_count_matches_the_package_without_fusion(config):
    from finalproject_losslessimagecompression_tpu_torch.bench import \
        train_flops_analytic
    from finalproject_losslessimagecompression_tpu_torch.models.config \
        import FlowCfg

    model = (tiny_config() if config == "tiny"
             else load(BENCH, "configs", "imagenet64.json"))["model"]
    cfg = FlowCfg.from_ref(model)
    cfg = dataclasses.replace(
        cfg, couple=dataclasses.replace(
            cfg.couple, nn=dataclasses.replace(cfg.couple.nn, fuse_1x1=False)),
        prior_nn=dataclasses.replace(cfg.prior_nn, fuse_1x1=False))
    assert flow_flops(arch(model), 16, True) == train_flops_analytic(cfg, 16)


def test_seeded_weights_fill_the_port_state_dict_exactly():
    from finalproject_losslessimagecompression_tpu_torch.models.config \
        import FlowCfg
    from finalproject_losslessimagecompression_tpu_torch.models.idflow \
        import IDFlow

    model = load(BENCH, "configs", "imagenet64.json")["model"]
    shapes = param_shapes(arch(model))
    port = IDFlow(FlowCfg.from_ref(tiny_config()["model"]), device="cpu")
    tiny = param_shapes(arch(tiny_config()["model"]))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == tiny
    assert sum(int(np.prod(s)) for s in shapes.values()) == 60_298_512
    a = seeded_weights(tiny, 2 ** 40 + 3, "cpu")
    b = seeded_weights(tiny, 2 ** 40 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_driver_steps_four_gloo_ranks_and_judges_correct():
    out = train.run(tiny_cell("imagenet64.train", trace=True, chips=4))
    assert out.correct, out.checks
    assert out.attempted % 4 == 0 and out.failed == 0
    assert run.metric_reader("train_mfu_pct").read(out.reading) > 0
