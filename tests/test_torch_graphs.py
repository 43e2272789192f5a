"""The port's one CUDA-graph runtime (`utils.graphs`) under the codecs
and the train steps, on the CPU with stub graphs.

`stub_graphs` turns a `GraphCache`'s graphs on with stub graphs by
replacing its one recording seam, `_record`: the card's call sequence (an
eager first call, a capture, replays) runs here, and the tests of the
codec, the steps and the spans use it.  The import-layering test holds the
bottom layers to importing nothing from the layers above them.
"""

from __future__ import annotations

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from finalproject_losslessimagecompression_tpu_torch import models as TM
from finalproject_losslessimagecompression_tpu_torch.utils.graphs import (
    GraphedStep,
    count_launch,
    record_launches,
)

PKG = "finalproject_losslessimagecompression_tpu_torch"
PKG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), PKG)


def _write(dst, src):
    """Copy src's tensors into dst's (tensors, dicts, lists, tuples and
    dataclasses of them), as a replay writes its static outputs."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _write(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _write(d, s)


class StubGraph:
    """What a CUDA graph's replay does, on the CPU: the captured function
    over the static inputs, its results written into the static outputs.
    The recording ran the capturing call's work (a CUDA capture runs none
    and its first replay does it), so the first replay does nothing; a
    later one re-runs the function inside `record_launches`, since the
    graph's tally counts its launches."""

    def __init__(self, run, outputs):
        self.run, self.outputs = run, outputs
        self.recorded = True

    def replay(self):
        if self.recorded:
            self.recorded = False
            return
        with record_launches():
            _write(self.outputs, self.run())


def stub_graphs(cache):
    """Turn a GraphCache's graphs on, on the CPU, with stub graphs."""
    cache.graphs = True

    def record(run):
        outputs = run()
        return StubGraph(run, outputs), outputs

    cache._record = record


class _Kernel:
    """A kernel wrapper's launch counter."""
    launches = 0


def _images(seed, batch):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(0, 1, (batch, 16, 16, 3)) * 256)
            / 256).astype(np.float32)


def _flow():
    nn = TM.DenseBlockCfg(8, 2, "ReLU")
    cfg = TM.FlowCfg(H=16, W=16, C=3, nflows=2, nsplit=2,
                     couple=TM.CouplingCfg(0.75, nn), prior_nn=nn)
    return TM.IDFlow(cfg, device="cpu").eval()


def _codec_user(wrapper):
    """A fused FlowCodec whose compress counts one launch of `wrapper`;
    call(i) compresses a batch of i + 1 images (key i) and holds its
    containers to the level path's."""
    codec = TM.FlowCodec(_flow(), num_streams=64, granularity="fused")
    level = TM.FlowCodec(codec.model, num_streams=64, granularity="level")
    real = codec.compress_pipeline

    def pipeline(xs, conds=None):
        count_launch(wrapper)
        return real(xs, conds)

    codec.compress_pipeline = pipeline

    def call(i):
        x = _images(i, i + 1)
        assert codec.compress_many([x]) == level.compress_many([x])

    return codec.graph_cache, codec, call, lambda i: ("compress", (i + 1,),
                                                      False)


def _step_user(wrapper):
    """A GraphedStep whose body counts one launch of `wrapper` and adds its
    input's sum to a state tensor in place; call(i) steps on i + 1
    elements (key i) and holds the output and the state to the body's
    arithmetic."""
    state = torch.zeros(())

    def body(x):
        count_launch(wrapper)
        state.add_(x.sum())
        return {"twice": x * 2.0}

    step = GraphedStep(body, "cpu")

    def call(i):
        x = torch.full((i + 1,), float(i))
        want = state + x.sum()
        got = step(x)
        assert torch.equal(got["twice"], x * 2.0)
        assert torch.equal(state, want)

    return step.cache, step, call, lambda i: (((i + 1,), torch.float32),)


# a call sequence and what the codec's own graph cache, before it was
# shared with the steps, counted for it at MAX_GRAPHS 2 and MAX_SEEN 3
SEQUENCE = [0, 0, 0] + list(range(10)) + [1, 2, 3, 1, 2, 3, 2, 1, 1]
PARENT_COUNTS = {"captures": 5, "replays": 8, "eager_calls": 14,
                 "evictions": 3}


@pytest.mark.parametrize("make", [_codec_user, _step_user],
                         ids=["codec", "step"])
def test_one_graph_rule_for_codec_and_step(make):
    """The codec and the step run the one rule: a key's first call
    eagerly, its second captures and replays, later calls replay, every
    output exact; each replay adds the launches its graph holds (the step
    too), so a launch is counted once per call on every path; at most
    MAX_GRAPHS graphs and MAX_SEEN keys met once are kept, the least
    recently used dropped first; and the counters equal what the codec's
    own cache counted for the same sequence.  Tolerance: exact."""
    wrapper = _Kernel()
    cache, user, call, key = make(wrapper)
    stub_graphs(cache)
    cache.MAX_GRAPHS, cache.MAX_SEEN = 2, 3
    want = [(0, 0, 1), (1, 1, 1), (1, 2, 1)]  # eager, capture, replay
    for i, w in zip(SEQUENCE, want):
        call(i)
        assert (user.captures, user.replays, user.eager_calls) == w
    for i in SEQUENCE[3:]:
        call(i)
    assert {k: getattr(user, k) for k in PARENT_COUNTS} == PARENT_COUNTS
    assert list(cache.entries) == [key(2), key(1)] and not cache.seen
    assert wrapper.launches == len(SEQUENCE)


def _imports(path):
    """Absolute names of the modules a source file imports."""
    here = os.path.relpath(os.path.dirname(path), os.path.dirname(PKG_DIR))
    parts = here.split(os.sep)
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = parts[:len(parts) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names += [mod] + [f"{mod}.{a.name}" for a in node.names]
    return names


@pytest.mark.parametrize("layer,banned", [
    ("utils", ("models", "train", "codec")),
    ("ops", ("models", "train", "codec.cuda_rans")),
])
def test_bottom_layers_import_nothing_from_above(layer, banned):
    """utils/ imports nothing from models/, train/ or codec/, and ops/
    nothing from models/, train/ or the rANS wrappers: the graph runtime,
    the launch tally and the arithmetic contract live at the bottom."""
    banned = tuple(f"{PKG}.{b}" for b in banned)
    found = []
    for name in sorted(os.listdir(os.path.join(PKG_DIR, layer))):
        if name.endswith(".py"):
            path = os.path.join(PKG_DIR, layer, name)
            found += [(name, m) for m in _imports(path)
                      if m.startswith(banned)]
    assert not found, found
