"""The PyTorch port's demo harnesses (`demo/`) and its PNG reader
(`utils/png.py`) held against PIL and the JAX package on the CPU.

Small size: the stress codes 200,000 symbols over 256 streams; the eval
and file-codec demos run a 16x16 flow (nflows 2, nsplit 2, growth 8,
depth 2) that the port's trainer saves, over two files of the in-domain
corpus.  Nothing here spawns a process.
"""

import gzip
import importlib.util
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
import yaml

from finalproject_losslessimagecompression_tpu.codec import (
    interleaved as JIL,
)
from finalproject_losslessimagecompression_tpu_torch import demo
from finalproject_losslessimagecompression_tpu_torch.cli.train import (
    build_trainer,
    load_config,
)
from finalproject_losslessimagecompression_tpu_torch.demo import (
    eval_phases,
    filecodec_demo,
    make_corpus,
    stress,
)
from finalproject_losslessimagecompression_tpu_torch.utils.png import (
    PNGError,
    as_rgb,
    read_png,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3):
# one call over every thread first keeps that out of the comparisons
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPORA = ("corpus", "corpus_indomain", "corpus_natural")


def _pil():
    from PIL import Image

    return Image


def _pngs(corpus):
    d = os.path.join(REPO, "demo", corpus)
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".png"))


@pytest.mark.parametrize("corpus", CORPORA)
def test_png_reader_equals_pil_on_committed_pngs(corpus):
    """Every committed PNG of the corpus decodes to PIL's pixels, and
    `as_rgb` to PIL's convert("RGB").  Tolerance: exact."""
    Image = _pil()
    paths = _pngs(corpus)
    assert len(paths) == 6
    for p in paths:
        got = read_png(p)
        assert np.array_equal(got, np.asarray(Image.open(p))), p
        assert np.array_equal(as_rgb(got),
                              np.asarray(Image.open(p).convert("RGB"))), p


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reader_colour_types(mode):
    """8-bit grey, grey + alpha, RGB and RGBA written by PIL (noise, which
    PIL files with filter 0, and smooth ramps, filtered with sub, up,
    average and Paeth) decode to PIL's pixels; `as_rgb` equals PIL's
    convert("RGB").  Tolerance: exact."""
    Image = _pil()
    c = len(mode)
    g = np.random.default_rng(len(mode) + 3)
    noise = g.integers(0, 256, (23, 41, c)).astype(np.uint8)
    ramp = (np.cumsum(noise, axis=1, dtype=np.int64) // 41).astype(np.uint8)
    for arr in (noise, ramp):
        b = io.BytesIO()
        Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(
            b, "PNG", optimize=True)
        got = read_png(b.getvalue())
        ref = Image.open(io.BytesIO(b.getvalue()))
        assert np.array_equal(got, arr)
        assert np.array_equal(as_rgb(got), np.asarray(ref.convert("RGB")))


def _chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _interlaced(data):
    """The PNG with IHDR's interlace method set to Adam7 (a valid CRC)."""
    ihdr = data[16:28] + b"\x01"
    return data[:8] + _chunk(b"IHDR", ihdr) + data[33:]


@pytest.mark.parametrize("case", ["interlaced", "16bit", "palette", "crc"])
def test_png_reader_refuses(tmp_path, case):
    """An interlaced PNG (PIL writes none, so IHDR is patched), a 16-bit
    one and a palette one made with PIL, and a damaged CRC are refused
    with a PNGError naming the reason."""
    Image = _pil()
    arr = np.random.default_rng(5).integers(0, 256, (9, 7, 3)).astype(
        np.uint8)
    path = tmp_path / "x.png"
    if case == "16bit":
        Image.fromarray(arr[..., 0].astype(np.uint16) * 257).save(path)
        match = "16-bit"
    elif case == "palette":
        Image.fromarray(arr).convert("P").save(path)
        match = "palette"
    else:
        Image.fromarray(arr).save(path)
        data = path.read_bytes()
        if case == "interlaced":
            data = _interlaced(data)
            match = "interlaced"
        else:
            data = data[:-5] + bytes([data[-5] ^ 1]) + data[-4:]
            match = "CRC"
        path.write_bytes(data)
    with pytest.raises(PNGError, match=match):
        read_png(str(path))


def _jax_make_corpus():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_make_corpus", os.path.join(REPO, "demo", "make_corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind,ds", [("indomain", "SyntheticImages"),
                                     ("natural", "NaturalSynthetic")])
def test_corpus_arrays_equal_committed_and_jax(tmp_path, kind, ds):
    """`corpus_arrays` equals the committed PNGs and the JAX make_corpus
    generation (its `_write` into tmp_path, read back by PIL); the `.npy`
    files `write_corpus` writes hold the same arrays, and it refuses the
    repository's demo/.  Tolerance: exact."""
    Image = _pil()
    got = make_corpus.corpus_arrays(kind)
    assert [n for n, _ in make_corpus.SIZES] == list(got)
    jmc = _jax_make_corpus()
    jmc._write(getattr(jmc, ds), str(tmp_path / "jax"))
    for name, arr in got.items():
        h, w = dict(make_corpus.SIZES)[name]
        assert arr.shape == (h, w, 3) and arr.dtype == np.uint8
        ref = np.asarray(Image.open(os.path.join(
            make_corpus.committed_dir(kind), name + ".png")))
        jax_png = np.asarray(Image.open(tmp_path / "jax" / (name + ".png")))
        assert np.array_equal(arr, ref), name
        assert np.array_equal(arr, jax_png), name
    paths = make_corpus.write_corpus(kind, str(tmp_path / "port"),
                                     png=False)
    for p, arr in zip(paths, got.values()):
        assert np.array_equal(np.load(p), arr)
    with pytest.raises(SystemExit, match="demo/"):
        make_corpus.write_corpus(kind, os.path.join(REPO, "demo", "x"))


def test_stress_on_the_cpu_matches_jax():
    """The stress at n = 200,000 and S = 256 on the CPU: the host path and
    the plain path bit-exact (no kernel path without a card); the word
    count within 0.1% of JAX's interleaved_encode on the same draw (the
    two CDFs' exp disagreements, ROADMAP section 3, move a few words)."""
    n, S = 200_000, 256
    out = stress.run(n=n, num_streams=S, iters=1, device="cpu")
    assert out["bit_exact"] and out["plain_bit_exact"]
    assert "kernel_bit_exact" not in out
    assert out["decode_windowed"] is None and out["device"] == "cpu"
    assert out["num_streams"] == S and out["steps"] == 784
    v, m, s = stress.draw(n)
    ref = JIL.interleaved_encode(v, m, s, num_streams=S)
    assert ref.num_streams == S
    jax_words = int(ref.num_words)
    assert abs(out["num_words"] - jax_words) <= 1e-3 * jax_words
    assert out["coded_bits_per_sym"] == 32.0 * out["num_words"] / n


def test_stress_without_the_plain_path():
    """`plain=False` leaves the plain path out and keeps the host path's
    round trip and counts (a caller then holds the kernels against the
    plain versions itself)."""
    out = stress.run(n=20_000, num_streams=256, iters=1, device="cpu",
                     plain=False)
    assert out["bit_exact"] and out["num_words"] > 0
    assert not any(k.startswith(("plain_", "kernel_")) for k in out)


def test_write_new_refuses_an_existing_file(tmp_path):
    path = str(tmp_path / "r.json")
    demo.write_new(path, {"a": 1})
    assert json.load(open(path)) == {"a": 1}
    with pytest.raises(SystemExit, match="exists"):
        demo.write_new(path, {"a": 2})


@pytest.fixture(scope="module")
def small_flow(tmp_path_factory):
    """(config path, trainer checkpoint) of a 16x16 flow (nflows 2, nsplit
    2, growth 8, depth 2) saved by the port's trainer, its projections
    perturbed so that it codes something."""
    tmp = tmp_path_factory.mktemp("flow")
    cfg = load_config(os.path.join(REPO, "configs", "smoke_synthetic.yaml"))
    t = cfg["train"]
    for nn in (t["model"]["couple"]["nn"], t["model"]["prior"]["nn"]):
        nn["growth_channel"] = 8
    t["save_path"] = str(tmp / "flow.ckpt")
    t["writer_path"] = str(tmp / "log")
    t["num_streams"] = 32
    path = tmp / "flow.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.MonkeyPatch.context() as mp:
        # the metrics writer would import TensorBoard (~10 s here)
        mp.setitem(sys.modules, "tensorboard", None)
        trainer = build_trainer(load_config(str(path)), device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            if ".proj." in name:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    trainer.save()
    return str(path), t["save_path"]


def test_eval_phases(small_flow, monkeypatch):
    """One Trainer.evaluate from the saved checkpoint: the JAX script's
    keys (`device` for `hardware`), JAX's evaluate keys, 0 coding errors
    over 2 batches, the real bpd within a few % of the test bpd."""
    config, ckpt = small_flow
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    out = eval_phases.run(config, ckpt, batches=2, device="cpu")
    assert set(out) == {"what", "device", "config", "ckpt", "eval"}
    ev = out["eval"]
    assert set(ev) == {"test_bpd", "forward_time", "real_bpd",
                       "coding_errors", "coding_time", "phase_report"}
    assert ev["coding_errors"] == 0
    assert ev["phase_report"]["encode"]["count"] == 2
    assert abs(ev["real_bpd"] - ev["test_bpd"]) < 0.05 * ev["test_bpd"]


def test_filecodec_demo_without_pil(small_flow, tmp_path, monkeypatch):
    """The file-codec demo over two in-domain files (6 and 16 tiles of
    16x16) with PIL blocked: every file exact, the JSON's keys those of
    the JAX demo's RESULTS_filecodec_r05_indomain.json (`device` for
    `platform`), at every level; WebP null and the `what` line saying why;
    PNG bytes the committed files'; gzip -9 and bpd computed."""
    config, ckpt = small_flow
    for name in ("PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    names = []
    out = filecodec_demo.run(
        config, ckpt, "indomain", workdir=str(tmp_path), device="cpu",
        num_streams=32, files=["img_29x37", "img_64x64_a"],
        around=lambda name: _noted(names, name))
    assert out["all_bit_exact"]
    with open(os.path.join(REPO, "RESULTS_filecodec_r05_indomain.json")) as f:
        ref = json.load(f)
    want = (set(ref) - {"platform"}) | {"device"}
    assert set(out) == want
    assert set(out["serve_marginal"]) == set(ref["serve_marginal"])
    assert all(set(r) == set(ref["files"][0]) for r in out["files"])
    assert out["device"] == "cpu" and out["serve_marginal"][
        "n_model_tiles"] == 22
    assert out["total_webp_bytes"] is None and out["lic_vs_webp"] is None
    assert "WebP not measured: PIL is not installed" in out["what"]
    arrays = make_corpus.corpus_arrays("indomain")
    for r in out["files"]:
        stem = r["file"][:-4]
        arr = arrays[stem]
        assert r["png_bytes"] == os.path.getsize(os.path.join(
            make_corpus.committed_dir("indomain"), stem + ".png"))
        assert r["gzip9_bytes"] == len(gzip.compress(arr.tobytes(), 9))
        assert r["lic_bpd"] == 8.0 * r["lic_bytes"] / arr.size
        assert r["webp_lossless_bytes"] is None and r["bit_exact"]
    assert out["lic_vs_png"] == out["total_lic_bytes"] / out[
        "total_png_bytes"]
    assert names == ["compress_cold", "compress_warm", "decompress_cold",
                     "decompress_warm", "serve_warmup_compress",
                     "serve_warmup_decompress"] + [
        f"serve_{d}_{i}" for i in range(3)
        for d in ("compress", "decompress")]


class _noted:
    """A context manager that records the command it wraps."""

    def __init__(self, names, name):
        names.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
