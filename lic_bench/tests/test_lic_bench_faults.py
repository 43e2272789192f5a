"""The comparison fails what it must: each cell's run driven at the tiny
size on the CPU (the look for a card skipped) with the timed path broken
underneath comes out not correct, under the cell's own limits, and the
TF32 control reads far above the sound program."""

from __future__ import annotations

from lic_bench import control
from lic_bench.drivers import bulk, request, train
from lic_bench.tests.tiny import tiny_cell

PKG = "finalproject_losslessimagecompression_tpu_torch"


def _exact():
    import importlib

    return importlib.import_module(PKG + ".models.exact")


def test_sound_runs_are_correct():
    assert bulk.run(tiny_cell("imagenet64.bulk")).correct
    assert train.run(tiny_cell("imagenet64.train")).correct
    assert request.run(tiny_cell("resflow-cond-imagenet64.request")).correct


def test_request_answer_altered_where_produced(monkeypatch):
    import importlib

    codec = importlib.import_module(
        PKG + ".models.residual_codec").ResidualCodec
    orig = codec.compress_many

    def altered(self, xs):
        out = orig(self, xs)
        idx_blob, blobs, info = out[0]
        b = bytearray(idx_blob)
        b[-1] ^= 1  # one index bit flipped in the stream it writes
        out[0] = (bytes(b), blobs, info)
        return out

    monkeypatch.setattr(codec, "compress_many", altered)
    out = request.run(tiny_cell("resflow-cond-imagenet64.request"))
    assert not out.correct and out.failed > 0


def test_bulk_answer_altered_where_produced(monkeypatch):
    codec = _exact().FlowCodec
    orig = codec.decompress_many

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        out[0] = out[0].copy()
        out[0].flat[7] += 1.0 / 256
        return out

    monkeypatch.setattr(codec, "decompress_many", altered)
    out = bulk.run(tiny_cell("imagenet64.bulk"))
    assert not out.correct and out.failed > 0


def test_bulk_latent_altered_before_coding(monkeypatch):
    exact = _exact()
    orig = exact.encode_tensors_deferred

    def altered(items, *a, **kw):
        (z, m, ls), rest = items[0], items[1:]
        z = z.clone()
        z.view(-1)[3] += 1.0 / 256
        return orig([(z, m, ls)] + list(rest), *a, **kw)

    monkeypatch.setattr(exact, "encode_tensors_deferred", altered)
    out = bulk.run(tiny_cell("imagenet64.bulk"))
    assert not out.correct
    assert out.checks["container_symbols_off"][0] > 0


def test_train_state_left_unchanged(monkeypatch):
    import importlib

    optim = importlib.import_module(PKG + ".train.optim")
    monkeypatch.setattr(optim.Optimizer, "update", lambda self, lr: None)
    out = train.run(tiny_cell("imagenet64.train"))
    assert not out.correct
    for key in ("change_gap", "change_gap.late"):
        assert out.checks[key][0] > out.checks[key][1]


def test_train_half_of_the_batch_left_out(monkeypatch):
    import importlib

    trainer = importlib.import_module(PKG + ".train.trainer")
    orig = trainer.flow_nll

    def half(model, batch, cond, conditional):
        return orig(model, batch[: batch.shape[0] // 2], cond, conditional)

    monkeypatch.setattr(trainer, "flow_nll", half)
    out = train.run(tiny_cell("imagenet64.train"))
    assert not out.correct
    assert out.checks["moment_gap"][0] > out.checks["moment_gap"][1]


def test_train_window_replays_stale_rows(monkeypatch):
    """A step that, once in the window, steps on the rows of the call
    before (a stale input in steady replay): the set-up calls are sound,
    and the call after the window catches it."""
    import importlib

    trainer = importlib.import_module(PKG + ".train.trainer")
    orig = trainer.make_multi_train_step

    def stale(*args, **kw):
        step, seen = orig(*args, **kw), []

        def call(x):
            seen.append(x.clone())
            return step(seen[-2] if len(seen) > 3 else x)
        return call

    monkeypatch.setattr(trainer, "make_multi_train_step", stale)
    out = train.run(tiny_cell("imagenet64.train"))
    assert not out.correct
    assert out.checks["loss_gap"][0] <= out.checks["loss_gap"][1]
    late = out.checks["moment_gap.median.late"]
    assert late[0] > late[1]


def _max(readings, key):
    return max(r[key] for r in readings)


def test_controls_read_far_above_sound_runs():
    """At this size, over three seeds, the TF32 control's widest prior gap
    is over ten times the sound program's, and so are the train control's
    moment and change gaps (its loss gap is near a float32 rounding of the
    loss here); half a batch left out reads above the moment gap's
    limit."""
    for workload, drv, read in (
            ("imagenet64.bulk", bulk, control.codec_readings),
            ("resflow-cond-imagenet64.request", request,
             control.request_readings)):
        ctl, sound = [], []
        for seed in (11, 12, 13):
            ctl += [n for _, n in read(tiny_cell(workload, seed=seed))]
            sound.append({k: v for k, (v, _) in
                          drv.run(tiny_cell(workload, seed=seed))
                          .checks.items()})
        assert _max(ctl, "prior_gap") > 10 * _max(sound, "prior_gap")
    readings = dict(control.train_readings(tiny_cell("imagenet64.train")))
    sound = train.run(tiny_cell("imagenet64.train")).checks
    for key in ("moment_gap", "change_gap"):
        assert readings["control_tf32"][key] > 10 * sound[key][0]
    assert readings["fault_half_batch"]["moment_gap"] > \
        sound["moment_gap"][1]


def _run_without_exchange(cell):
    """A rank's run whose gradient all_reduce is left out: each rank
    steps on its own gradient and reports its own loss."""
    import importlib

    mesh = importlib.import_module(PKG + ".parallel.mesh")
    orig = mesh.Mesh.all_reduce

    def own(self, t, op="sum", axis=None):
        if op == "sum" and t.numel() > 1:
            return t.detach() * self.size
        return orig(self, t, op, axis)

    mesh.Mesh.all_reduce = own
    try:
        return train.run(cell)
    finally:
        mesh.Mesh.all_reduce = orig


def test_train_on_four_ranks_exchange_between_chips_left_out():
    from lic_bench import harness

    out = harness.run_ranks(tiny_cell("imagenet64.train", chips=4),
                            _run_without_exchange)
    assert not out.correct
