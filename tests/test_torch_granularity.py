"""The port's FlowCodec granularity modes held against the JAX package.

"level", "nn" and "fused" must write byte-identical containers and decode
each other's exactly; the fused decompress runs its pipeline over the
containers' padded form (device-side bits-back hole, tail check and escape
patch), and on the CPU it runs eagerly, as here.  The same flax parameters
(perturbed from numpy seeds) are loaded into both packages.  Small size:
16x16x3 images, nflows 2, growth 8, depth 2, num_streams 64.
"""

import functools
import os
import sys
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from finalproject_losslessimagecompression_tpu import models as JM
from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch.cli import codec as C
from finalproject_losslessimagecompression_tpu_torch.cli.train import (
    load_config,
)
from finalproject_losslessimagecompression_tpu_torch.codec import cuda_rans
from finalproject_losslessimagecompression_tpu_torch.codec.coder import (
    states_ok,
)
from finalproject_losslessimagecompression_tpu_torch.codec.container import (
    unpack_streams,
)
from finalproject_losslessimagecompression_tpu_torch.codec.interleaved import (  # noqa: E501
    EncodedStreams,
    fill_hole,
    padded_size,
)
from finalproject_losslessimagecompression_tpu_torch.convert import (
    params_from_flax,
)
from finalproject_losslessimagecompression_tpu_torch.models.twolevel import (  # noqa: E501
    TwoLevelCfg,
    TwoLevelFlow,
)
from finalproject_losslessimagecompression_tpu_torch.models.twolevel_codec import (  # noqa: E501
    TwoLevelCodec,
)
from finalproject_losslessimagecompression_tpu_torch.train.checkpoint import (
    save_checkpoint,
)
from finalproject_losslessimagecompression_tpu_torch.utils import graphs

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3):
# one call over every thread first keeps that out of the comparisons
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_residual import _flow_dict  # noqa: E402
from test_torch_graphs import stub_graphs  # noqa: E402
from test_torch_twolevel import _tl_dict  # noqa: E402

MODES = ("level", "nn", "fused")
VARIANTS = ("plain", "conditional", "batch_squeeze", "bfloat16")


def _images(seed, batch=2):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(0, 1, (batch, 16, 16, 3)) * 256)
            / 256).astype(np.float32)


def _cfg(M, variant, nsplit=2):
    if variant == "conditional":
        return M.FlowCfg.from_ref(dict(_flow_dict(True), H=16, W=16,
                                       nsplit=nsplit))
    nn = M.DenseBlockCfg(8, 2, "ReLU")
    cfg = M.FlowCfg(H=16, W=16, C=3, nflows=2, nsplit=nsplit,
                    couple=M.CouplingCfg(0.75, nn), prior_nn=nn)
    if variant == "batch_squeeze":
        return replace(cfg, batch_squeeze=2)
    if variant == "bfloat16":
        nn = replace(nn, dtype="bfloat16")
        return replace(cfg, prior_nn=nn, couple=replace(cfg.couple, nn=nn))
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(variant="plain", nsplit=2, seed=0):
    """(JAX IDFlow, flax params, port IDFlow with them): every leaf drawn
    from N(0, 0.05^2) with numpy (the flax tree's shapes from eval_shape,
    which traces without compiling), so no projection is zero.  Nothing
    here mutates a model, so the tests share them."""
    jm = JM.IDFlow(_cfg(JM, variant, nsplit))
    px = jnp.zeros((1, 16, 16, 3), jnp.float32)
    args = (px, px) if variant == "conditional" else (px,)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed + 7)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32), shapes)
    tm = TM.IDFlow(_cfg(TM, variant, nsplit), device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _perturbed(model, seed):
    """Fresh projections are zero: perturb them by N(0, 0.05^2)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".proj." in name:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _codecs(tm):
    return {g: TM.FlowCodec(tm, num_streams=64, granularity=g)
            for g in MODES}


@pytest.mark.parametrize("variant", VARIANTS)
def test_modes_byte_identical_and_cross_decode(variant):
    """The three modes write the same containers for a queue of two batch
    sizes, each decodes every mode's containers exactly, and the fused
    real bpd is within 1% of the JAX FlowCodec's in "fused" mode on the
    same batch and weights (containers match across packages only on
    agreement-filtered symbols, ROADMAP section 3).  Tolerance: exact,
    then 1% of bpd."""
    jm, params, tm = _pair(variant)
    xs = [_images(10), _images(11, batch=1)]
    conds = ([_images(12), _images(13, batch=1)]
             if variant == "conditional" else None)
    codecs = _codecs(tm)
    packed = {g: c.compress_many(xs, conds) for g, c in codecs.items()}
    assert packed["level"] == packed["nn"] == packed["fused"]
    for g, codec in codecs.items():
        for h in MODES:
            got = codec.decompress_many(packed[h], conds, fetch=True)
            assert all(np.array_equal(r, x) for r, x in zip(got, xs)), (g, h)
        assert codec.level_fallbacks == 0
    blobs, info = packed["fused"][0]
    jcodec = JM.FlowCodec(jm, num_streams=64, granularity="fused")
    jblobs, jinfo = jcodec.compress(
        params, jnp.asarray(xs[0]),
        None if conds is None else jnp.asarray(conds[0]))
    bpd = codecs["fused"].real_bpd(blobs, info)
    jbpd = jcodec.real_bpd(jblobs, jinfo)
    assert abs(bpd - jbpd) <= 0.01 * jbpd, (bpd, jbpd)


def _outlier_batch():
    """Pixels far outside the prior's +-4 window (as the JAX package's
    TestEscapeMatrix builds them): each escapes in some level."""
    x = _images(20)
    x[:, ::3, ::3, 0] += 40.0
    return x


@pytest.mark.parametrize("max_outliers", [4, 256])
def test_escape_matrix(max_outliers, monkeypatch):
    """MAX_OUTLIERS 4: the fused program is not called, the queue takes
    the level path (counted) and round-trips exactly.  The default 256:
    the escapes are patched inside the fused program, exactly.
    Tolerance: exact."""
    _, _, tm = _pair()
    codec = TM.FlowCodec(tm, num_streams=64, granularity="fused")
    if max_outliers != TM.FlowCodec.MAX_OUTLIERS:
        codec.MAX_OUTLIERS = max_outliers  # an instance override
    x = _outlier_batch()
    blobs, info = codec.compress(x)
    counts = [unpack_streams(b).oow_count for b in blobs]
    assert 4 < max(counts) <= 256, counts
    fused_called = []
    real = graphs.GraphCache.__call__
    monkeypatch.setattr(graphs.GraphCache, "__call__", lambda *a: (
        fused_called.append(1) or real(*a)))
    rec = codec.decompress(blobs, info, fetch=True)
    assert np.array_equal(rec, x)
    over = max(counts) > max_outliers
    assert bool(fused_called) != over
    assert codec.level_fallbacks == int(over)


def test_device_side_hole_fill_and_tail_check_equal_host():
    """On a 3-level queue: the bits-back hole fill with the donated count
    as a 0-d tensor equals the host slice; the tail check with a 0-d tail
    start equals the host one; and the fused decode over the padded form
    (every count a tensor) returns the images and flags of the level
    pipeline run over the unpacked host containers (every count an int).
    Tolerance: exact."""
    _, _, tm = _pair(nsplit=3, seed=3)
    codecs = _codecs(tm)
    xs = [_images(30), _images(31, batch=1)]
    packed = codecs["level"].compress_many(xs)
    rng = np.random.default_rng(32)
    checked = 0
    for (blobs, info) in packed:
        encs = codecs["level"]._unpack_checked(blobs, info["batch"])
        for level in range(1, 3):
            donor, e = encs[level - 1], encs[level]
            fill = rng.integers(0, 1 << 32, e.num_streams)
            want = np.asarray(donor.words, np.int64).copy()
            want[:donor.donated] = fill[:donor.donated]
            for d in (donor.donated, torch.tensor(donor.donated)):
                buf = torch.from_numpy(np.asarray(donor.words, np.int64))
                fill_hole(buf, torch.from_numpy(fill), d)
                assert np.array_equal(buf.numpy(), want)
            hi = torch.ones(e.num_streams, dtype=torch.int64)
            lo = torch.from_numpy(rng.integers(0, 2, e.num_streams))
            host = bool((lo.numpy()[donor.donated:] == 0).all())
            assert bool(states_ok(hi, lo, donor.donated)) == host
            assert bool(states_ok(hi, lo, torch.tensor(donor.donated))) \
                == host
            checked += 1
    assert checked == 4
    batches = [info["batch"] for _, info in packed]
    encs = [codecs["level"]._unpack_checked(b, n) for (b, _), n in
            zip(packed, batches)]
    want = codecs["level"].decompress_pipeline(encs, batches)
    assert isinstance(encs[0][1].donated, int)
    got = codecs["fused"].decode_queue(packed)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert torch.equal(a, b)
    assert all(bool(ok) for ok in got[1])


def test_padded_form_round_trips():
    """EncodedStreams.padded has the plan's fixed length and from_padded
    reads back every field; more escapes than the padding holds raise.
    Tolerance: exact."""
    _, _, tm = _pair()
    codec = TM.FlowCodec(tm, num_streams=64, granularity="level")
    blobs, _ = codec.compress(_outlier_batch())
    for blob in blobs:
        e = unpack_streams(blob)
        flat = e.padded(256)
        assert flat.shape == (padded_size(e.n, e.num_streams, 256),)
        p = EncodedStreams.from_padded(torch.from_numpy(flat), e.n,
                                       e.num_streams, 256)
        m = e.oow_count
        assert np.array_equal(p.words.numpy(), e.words)
        assert int(p.num_words) == e.num_words
        assert int(p.donated) == e.donated and int(p.oow_count) == m
        assert np.array_equal(p.state_hi.numpy(), e.state_hi)
        assert np.array_equal(p.state_lo.numpy(), e.state_lo)
        assert np.array_equal(p.oow_idx[:m].numpy(), e.oow_idx[:m])
        assert bool((p.oow_idx[m:] == e.n).all())
        assert np.array_equal(p.oow_vals[:m].numpy(), e.oow_vals[:m])
    assert max(unpack_streams(b).oow_count for b in blobs) > 4
    with pytest.raises(ValueError, match="escapes"):
        for blob in blobs:
            unpack_streams(blob).padded(4)


def test_fused_rejects_corrupt_containers():
    """Under "fused", containers that do not match the level plans, or a
    corrupted one, raise ValueError.  Tolerance: exact."""
    _, _, tm = _pair()
    codec = TM.FlowCodec(tm, num_streams=64, granularity="fused")
    blobs, info = codec.compress(_images(40))
    with pytest.raises(ValueError):
        codec.decompress(blobs[:1], info)
    with pytest.raises(ValueError):
        codec.decompress(blobs[::-1], info)
    with pytest.raises(ValueError):
        codec.decompress(blobs, {"batch": 1})
    bad = bytearray(blobs[1])
    bad[40] ^= 0x5A
    with pytest.raises(ValueError):
        codec.decompress([blobs[0], bytes(bad)], info)
    assert codec.level_fallbacks == 0


def test_granularity_resolution(monkeypatch):
    """None resolves to "level" on the CPU and to "fused" on a CUDA
    device, as JAX picks "fused" on its accelerator; any other value
    raises."""
    _, _, tm = _pair()
    assert TM.FlowCodec(tm).granularity == "level"
    # "nn" is accepted, as in JAX, and is the level path
    assert TM.FlowCodec(tm, granularity="nn").granularity == "level"
    with pytest.raises(ValueError, match="granularity"):
        TM.FlowCodec(tm, granularity="program")
    monkeypatch.setattr(graphs, "set_deterministic_cuda", lambda: None)
    on_card = SimpleNamespace(cfg=tm.cfg, plans=tm.plans,
                              device=torch.device("cuda"))
    assert TM.FlowCodec(on_card).granularity == "fused"
    assert TM.FlowCodec(on_card, granularity="level").granularity == "level"


def test_replay_accounting_through_a_stub_graph():
    """Launches during a capture go to the capture's tally, not the
    counters; every replay adds the tally.  The codec's graph cache runs a
    key's first call eagerly, captures at its second (the launches the
    graph holds tallied, none counted), fills the static inputs on every
    call and clones the outputs, so an earlier result survives a later
    replay.  Tolerance: exact."""
    wrappers = (cuda_rans.rans_cdf_prepass, cuda_rans.rans_encode,
                cuda_rans.rans_decode)
    before = [w.launches for w in wrappers]
    with graphs.record_launches() as tally:
        for w in wrappers + wrappers[1:]:
            graphs.count_launch(w)
    assert [w.launches for w in wrappers] == before
    assert tally == {wrappers[0]: 1, wrappers[1]: 2, wrappers[2]: 2}

    class Stub:
        replays = 0

        def replay(self):
            self.replays += 1

    stub = Stub()
    graph = graphs.CountedGraph(stub, tally)
    graph.replay()
    graph.replay()
    assert stub.replays == 2
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2, 4, 4]

    _, _, tm = _pair()
    codec = TM.FlowCodec(tm, num_streams=64, granularity="fused")
    cache = codec.graph_cache
    stub_graphs(cache)  # the card's path, with stub graphs on the CPU
    record = cache._record

    def record_a_decode(run):
        graphs.count_launch(cuda_rans.rans_decode)  # a launch it holds
        return record(run)

    cache._record = record_a_decode
    decodes = cuda_rans.rans_decode.launches

    def call(key, value):
        return cache(key, lambda s: s[0] * 2,
                     ([torch.full((3,), float(value))],))

    # first sight runs eagerly; the second captures and replays
    first = call("k", 1)
    assert codec.captures == 0 and len(cache.entries) == 0
    second = call("k", 5)
    assert cuda_rans.rans_decode.launches == decodes + 1
    third = call("k", 7)
    assert codec.captures == 1 and codec.replays == 2
    for got, v in ((first, 1), (second, 5), (third, 7)):
        assert torch.equal(got, torch.full((3,), 2.0 * v))
    assert cuda_rans.rans_decode.launches == decodes + 2


def test_graph_cache_is_bounded_least_recently_used_first():
    """The fused mode keeps at most MAX_GRAPHS graphs and MAX_SEEN
    signatures met once, the least recently used dropped first: a queue
    layout met once is never captured, a dropped one runs eagerly again
    and is captured anew when met again.  Tolerance: exact."""
    _, _, tm = _pair()
    codec = TM.FlowCodec(tm, num_streams=64, granularity="fused")
    cache = codec.graph_cache
    stub_graphs(cache)
    cache.MAX_GRAPHS, cache.MAX_SEEN = 2, 3

    def call(key):
        got = cache(key, lambda s: s[0] + 1,
                    ([torch.full((2,), float(key))],))
        assert torch.equal(got, torch.full((2,), key + 1.0))

    for key in range(10):  # distinct layouts: nothing captured
        call(key)
    assert codec.captures == 0 and list(cache.seen) == [7, 8, 9]
    for key in (1, 2, 3, 1, 2, 3):  # 1 and 2 captured, then 3 drops 1
        call(key)
    assert codec.captures == 3 and list(cache.entries) == [2, 3]
    call(2)  # a replay makes 2 the most recent
    call(1)  # dropped: eagerly, then captured at its next call
    assert codec.captures == 3
    call(1)
    assert codec.captures == 4 and list(cache.entries) == [2, 1]
    assert codec.evictions == 2


def test_twolevel_fused_equals_level():
    """TwoLevelCodec passes the granularity to both sub-flows: "fused"
    writes the "level" containers byte for byte, and each decodes the
    other's exactly.  Its default resolves to "level" on the CPU.
    Tolerance: exact."""
    tm = _perturbed(TwoLevelFlow(TwoLevelCfg.from_ref(_tl_dict()),
                                 device="cpu", seed=6), 7)
    level = TwoLevelCodec(tm, num_streams=32)
    fused = TwoLevelCodec(tm, num_streams=32, granularity="fused")
    assert level.rough_codec.granularity == "level"
    assert fused.fine_codec.granularity == "fused"
    xs = [_images(50, batch=2)[:, :15, :15], _images(51, batch=1)[:, :15,
                                                                  :15]]
    packed = fused.compress_many(xs)
    assert packed == level.compress_many(xs)
    for a, b in ((fused, level), (level, fused)):
        got = a.decompress_many(packed, fetch=True)
        assert all(np.array_equal(r, x) for r, x in zip(got, xs))


def test_compress_file_decompress_file(tmp_path):
    """cli.codec.compress_file / decompress_file round-trip one file
    through the plain pipeline.  Tolerance: exact."""
    config = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
    cfg = TM.FlowCfg.from_ref(load_config(config)["train"]["model"])
    model = _perturbed(TM.IDFlow(cfg, device="cpu", seed=1), 2)
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, {"params": model.state_dict()})
    pipe = C._load_model(config, ckpt, 32, device="cpu")
    arr = np.random.default_rng(3).integers(0, 256, (20, 13, 3)).astype(
        np.uint8)
    src, lic = str(tmp_path / "img.npy"), str(tmp_path / "img.lic")
    np.save(src, arr)
    assert C.compress_file(pipe, src, lic, stored_fallback=False) == "flow"
    out = str(tmp_path / "back.npy")
    C.decompress_file(pipe, lic, out)
    assert np.array_equal(np.load(out), arr)


def test_cli_granularity_flag(tmp_path):
    """The codec CLI's --granularity reaches the codec: a file compressed
    with "fused" decompresses with "level" (and the default) exactly, and
    "nn" reads back as "level".  Tolerance: exact."""
    config = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
    cfg = TM.FlowCfg.from_ref(load_config(config)["train"]["model"])
    model = _perturbed(TM.IDFlow(cfg, device="cpu", seed=1), 3)
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, {"params": model.state_dict()})
    for g in ("fused", "nn"):
        pipe = C._load_model(config, ckpt, 32, device="cpu", granularity=g)
        assert pipe.codec.granularity == {"nn": "level"}.get(g, g)
    arr = np.random.default_rng(4).integers(0, 256, (9, 17, 3)).astype(
        np.uint8)
    src = str(tmp_path / "img.npy")
    np.save(src, arr)
    args = ["--config", config, "--ckpt", ckpt, "--num-streams", "32",
            "--device", "cpu", "--no-stored-fallback", "--ext", ".npy"]
    C.main(["compress", "--input", src, "--outdir", str(tmp_path / "c"),
            "--granularity", "fused"] + args)
    lic = str(tmp_path / "c" / "img.lic")
    for g in (["--granularity", "level"], []):
        out = tmp_path / f"d{len(g)}"
        C.main(["decompress", "--input", lic, "--outdir", str(out)] + g
               + args)
        assert np.array_equal(np.load(out / "img.npy"), arr)
