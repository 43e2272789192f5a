"""The PyTorch port's file codec CLI (`cli/codec.py`) on the CPU.

Everything runs through `main([..., "--device", "cpu"])` or the module's
functions, with checkpoints the port saves (`{"params": state_dict}`) from
seeded weights whose zero-initialised projections are perturbed, so that
the flow codes something.  The plain model is configs/smoke_synthetic.yaml's
(16x16 tiles, nflows 2, nsplit 2); the residual one is 16x16 images over
8x8 conditional-flow tiles with a VQ-VAE of hidden dims [8, 16].
"""

import io
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
import yaml

from finalproject_losslessimagecompression_tpu.cli import codec as JC
from finalproject_losslessimagecompression_tpu.models import config as jconfig
from finalproject_losslessimagecompression_tpu_torch.cli import codec as C
from finalproject_losslessimagecompression_tpu_torch.cli.train import (
    load_config,
)
from finalproject_losslessimagecompression_tpu_torch.models import (
    IDFlow,
    build_vqvae_from_ref,
)
from finalproject_losslessimagecompression_tpu_torch.models.config import (
    FlowCfg,
)
from finalproject_losslessimagecompression_tpu_torch.train.checkpoint import (
    save_checkpoint,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# the first parallel CPU exp of a process can be off (ROADMAP section 3):
# one call over every thread first keeps that out of the comparisons
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_residual import VQ_DICT, _flow_dict  # noqa: E402


def _perturbed(module, seed, sd=0.05):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if ".proj." in name or "codebook" in name:
                p.add_(sd * torch.randn(p.shape, generator=g))
    return module


def _save(module, path):
    save_checkpoint(str(path), {"params": module.state_dict()})
    return str(path)


@pytest.fixture(scope="module")
def plain_ckpt(tmp_path_factory):
    cfg = FlowCfg.from_ref(load_config(PLAIN)["train"]["model"])
    tmp = tmp_path_factory.mktemp("plain")
    return _save(_perturbed(IDFlow(cfg, device="cpu"), 1), tmp / "m.ckpt")


def _args(ckpt, outdir, *extra, config=PLAIN):
    return ["--config", config, "--ckpt", ckpt, "--outdir", str(outdir),
            "--num-streams", "32", "--device", "cpu", *extra]


def _img(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)
    return str(path)


def _load_png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _write_yaml(path, obj):
    """Block-style YAML with no anchors (the port's reader takes neither
    flow collections nor aliases): distinct copies of shared subtrees."""
    path.write_text(yaml.safe_dump(json.loads(json.dumps(obj))))
    return str(path)


def _header(path):
    with open(path, "rb") as f:
        data = f.read()
    (hlen,) = struct.unpack("<I", data[4:8])
    return json.loads(data[8:8 + hlen]), data[8 + hlen:]


def test_roundtrip_npy_png_tiled_and_subtile(plain_ckpt, tmp_path):
    """.npy and .png inputs -> .lic -> the exact pixels: a one-tile .npy,
    a sub-tile PNG and a PNG larger than the model (6 tiles, chunks 4 + 2),
    decompressed both to PNG and to .npy; the plain pipeline returns host
    numpy.  Tolerance: exact."""
    imgs = {"a.npy": _img(1, (16, 16, 3)), "t.png": _img(2, (12, 14, 3)),
            "big.png": _img(3, (20, 35, 3))}
    srcs = []
    for name, arr in imgs.items():
        p = tmp_path / name
        srcs.append(_png(p, arr) if name.endswith(".png")
                    else (np.save(p, arr), str(p))[1])
    out = tmp_path / "out"
    C.main(["compress", "--input", *srcs]
           + _args(plain_ckpt, out, "--no-stored-fallback"))
    lics = [str(out / (os.path.splitext(n)[0] + ".lic")) for n in imgs]
    h, _ = _header(lics[2])
    assert [c["info"]["batch"] for c in h["chunks"]] == [4, 2]
    assert h["mode"] == "flow" and h["pipeline"] == "plain"
    C.main(["decompress", "--input", *lics] + _args(plain_ckpt, out))
    for name, arr in imgs.items():
        assert np.array_equal(
            _load_png(out / (os.path.splitext(name)[0] + ".png")), arr)
    C.main(["decompress", "--input", *lics]
           + _args(plain_ckpt, tmp_path / "npy", "--ext", ".npy"))
    for name, arr in imgs.items():
        assert np.array_equal(np.load(
            tmp_path / "npy" / (os.path.splitext(name)[0] + ".npy")), arr)
    pipe = C._load_model(PLAIN, plain_ckpt, 32, device="cpu")
    _, chunks, _ = C._read_lic(pipe, lics[2])
    assert all(isinstance(r, np.ndarray) for r in pipe.decompress_many(chunks))


def test_chunk_sizes_match_jax():
    """_chunk_sizes equals the JAX module's for 1..1000 tiles at several
    caps.  Tolerance: exact."""
    for cap in (1, 8, 64):
        for n in range(1, 1001):
            assert C._chunk_sizes(n, cap) == JC._chunk_sizes(n, cap)
    assert C._chunk_sizes(12) == [8, 4]


def test_containers_cross_parse_with_jax(tmp_path):
    """A container laid out by the JAX module's _container_bytes is parsed
    by the port's _read_lic, and the port's by the JAX module's: the LIC1
    layout and format version 2 are shared.  Tolerance: exact."""

    class Pipe:
        name, fingerprint = "plain", "f" * 16

    header = {"v": 2, "orig": [5, 7, 3], "nbits": 8, "pipeline": "plain",
              "mode": "flow", "chunks": [{"nseg": 2, "info": {"batch": 1}},
                                         {"nseg": 1, "info": {"batch": 2}}],
              "blob_lens": [3, 0, 4], "fingerprint": "f" * 16}
    segs = [b"abc", b"", b"defg"]
    assert C._container_bytes(header, segs) == JC._container_bytes(
        header, segs)
    for make, read in ((JC._container_bytes, C._read_lic),
                       (C._container_bytes, JC._read_lic)):
        p = tmp_path / "x.lic"
        p.write_bytes(make(header, segs))
        mode, chunks, orig = read(Pipe(), str(p))
        assert mode == "flow" and orig == [5, 7, 3]
        assert chunks == [([b"abc", b""], {"batch": 1}),
                          ([b"defg"], {"batch": 2})]
    p.write_bytes(C._container_bytes({**header, "v": 1}, segs))
    with pytest.raises(SystemExit, match="older"):
        C._read_lic(Pipe(), str(p))
    p.write_bytes(C._container_bytes(header, segs) + b"!")
    with pytest.raises(SystemExit, match="trailing"):
        C._read_lic(Pipe(), str(p))


def test_fingerprint_and_backend_mismatch(plain_ckpt, tmp_path):
    """Other weights, another backend's tag or the JAX package's variant
    tag give another fingerprint, and decompress refuses the container with
    SystemExit.  Tolerance: exact."""
    src = str(tmp_path / "a.npy")
    np.save(src, _img(4, (16, 16, 3)))
    C.main(["compress", "--input", src]
           + _args(plain_ckpt, tmp_path, "--no-stored-fallback"))
    lic = str(tmp_path / "a.lic")
    cfg = FlowCfg.from_ref(load_config(PLAIN)["train"]["model"])
    other = _save(_perturbed(IDFlow(cfg, device="cpu"), 2),
                  tmp_path / "o.ckpt")
    with pytest.raises(SystemExit, match="different model"):
        C.main(["decompress", "--input", lic] + _args(other, tmp_path))
    model_cfg = dict(load_config(PLAIN)["train"]["model"])
    tags = [C._variant_tag(cfg, "cpu"), C._variant_tag(cfg, "cuda"),
            JC._variant_tag(jconfig.FlowCfg.from_ref(model_cfg))]
    assert tags[0].endswith("backend=torch-cpu")
    assert tags[1].endswith("backend=torch-cuda")
    fps = [C._fingerprint(model_cfg, t, plain_ckpt) for t in tags]
    assert len(set(fps)) == 3
    h, blobs = _header(lic)
    assert h["fingerprint"] == fps[0]
    for fp in fps[1:]:
        bad = tmp_path / "bad.lic"
        bad.write_bytes(C._container_bytes({**h, "fingerprint": fp},
                                           [blobs]))
        with pytest.raises(SystemExit, match="backend"):
            C.main(["decompress", "--input", str(bad)]
                   + _args(plain_ckpt, tmp_path))


def test_serve_session(plain_ckpt, tmp_path):
    """One loaded pipeline serves several commands: `ok <seconds>` per
    compress / decompress, `err` for an unknown command, a timing report
    with the model loaded once, and bit-exact files.  Tolerance: exact."""
    srcs = []
    for i, shape in enumerate([(12, 14, 3), (20, 35, 3)]):
        srcs.append((_png(tmp_path / f"s{i}.png", _img(9 + i, shape)),
                     _img(9 + i, shape)))
    C.TIMER.totals.clear()
    C.TIMER.counts.clear()
    pipe = C._load_model(PLAIN, plain_ckpt, 32, device="cpu")
    outdir = str(tmp_path / "serve_out")
    lines = [
        f"compress {outdir} {srcs[0][0]} {srcs[1][0]}",
        f"compress {outdir} {srcs[0][0]} {srcs[1][0]}",
        "decompress %s %s %s" % (outdir, os.path.join(outdir, "s0.lic"),
                                 os.path.join(outdir, "s1.lic")),
        "timing",
        "bogus command",
        "quit",
        "compress never reached",
    ]
    out = io.StringIO()
    C.serve(pipe, lines=lines, out=out, stored_fallback=False)
    emitted = out.getvalue().splitlines()
    oks = [ln for ln in emitted if ln.startswith("ok ")]
    assert len(oks) == 3 and all(float(ln.split()[1]) >= 0 for ln in oks)
    assert any(ln.startswith("err ") for ln in emitted)
    timing = json.loads([ln for ln in emitted if ln.startswith("{")][0])[
        "phases"]
    assert timing["startup:load_model"]["count"] == 1
    assert timing["compress:dispatch_pack"]["count"] == 2
    assert timing["decompress:dispatch_verify"]["count"] == 1
    for p, img in srcs:
        assert np.array_equal(
            _load_png(os.path.join(outdir, os.path.basename(p))), img)


def test_stored_escape_with_pil(plain_ckpt, tmp_path):
    """A sub-tile noise image takes the stored-png escape, never larger
    than the header plus PNG; a mixed stored + flow request decodes
    exactly; a stored container decodes under another checkpoint.
    Tolerance: exact."""
    from PIL import Image

    noise, flat = _img(11, (5, 6, 3)), np.full((8, 8, 3), 37, np.uint8)
    nsrc, fsrc = _png(tmp_path / "noise.png", noise), _png(
        tmp_path / "flat.png", flat)
    C.main(["compress", "--input", nsrc, fsrc] + _args(plain_ckpt, tmp_path))
    nlic = str(tmp_path / "noise.lic")
    h, _ = _header(nlic)
    assert h["mode"] == "stored-png"
    b = io.BytesIO()
    Image.fromarray(noise).save(b, format="PNG", optimize=True)
    hlen = len(json.dumps(h).encode())
    assert os.path.getsize(nlic) <= 8 + hlen + min(b.tell(),
                                                   os.path.getsize(nsrc))
    C.main(["decompress", "--input", nlic, str(tmp_path / "flat.lic")]
           + _args(plain_ckpt, tmp_path))
    assert np.array_equal(_load_png(tmp_path / "noise.png"), noise)
    assert np.array_equal(_load_png(tmp_path / "flat.png"), flat)
    cfg = FlowCfg.from_ref(load_config(PLAIN)["train"]["model"])
    other = _save(_perturbed(IDFlow(cfg, device="cpu"), 5),
                  tmp_path / "o.ckpt")
    C.main(["decompress", "--input", nlic] + _args(other, tmp_path))
    assert np.array_equal(_load_png(tmp_path / "noise.png"), noise)


def test_stored_escape_without_pil(plain_ckpt, tmp_path, monkeypatch):
    """With PIL not importable: the escape is stored-zlib and round-trips
    through .npy; a stored-png container and a .png input are read by the
    package's own PNG reader (utils/png.py) and decode to the exact
    pixels; a .png output and an input that is neither .png nor .npy raise
    SystemExit naming PIL.  Tolerance: exact."""
    png_noise = _img(12, (5, 6, 3))
    png_lic = tmp_path / "p.lic"
    C.main(["compress", "--input", _png(tmp_path / "p.png", png_noise)]
           + _args(plain_ckpt, tmp_path))
    assert _header(png_lic)[0]["mode"] == "stored-png"
    big = _img(14, (20, 35, 3))
    big_png = _png(tmp_path / "q.png", big)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    noise = _img(13, (5, 6, 3))
    src = str(tmp_path / "n.npy")
    np.save(src, noise)
    out = tmp_path / "out"
    C.main(["compress", "--input", src] + _args(plain_ckpt, out))
    assert _header(out / "n.lic")[0]["mode"] == "stored-zlib"
    C.main(["decompress", "--input", str(out / "n.lic")]
           + _args(plain_ckpt, out, "--ext", ".npy"))
    assert np.array_equal(np.load(out / "n.npy"), noise)
    C.main(["decompress", "--input", str(png_lic)]
           + _args(plain_ckpt, out, "--ext", ".npy"))
    assert np.array_equal(np.load(out / "p.npy"), png_noise)
    C.main(["compress", "--input", big_png, "--no-stored-fallback"]
           + _args(plain_ckpt, out))
    assert _header(out / "q.lic")[0]["mode"] == "flow"
    C.main(["decompress", "--input", str(out / "q.lic")]
           + _args(plain_ckpt, out, "--ext", ".npy"))
    assert np.array_equal(np.load(out / "q.npy"), big)
    (tmp_path / "p.bmp").write_bytes(b"BM")
    with pytest.raises(SystemExit, match="PIL"):
        C.main(["compress", "--input", str(tmp_path / "p.bmp")]
               + _args(plain_ckpt, out))
    with pytest.raises(SystemExit, match="PIL"):
        C.main(["decompress", "--input", str(out / "n.lic")]
               + _args(plain_ckpt, out))


def _residual_setup(tmp_path):
    """(config path, flow checkpoint) of a residual config whose VQ-VAE
    checkpoint the config names."""
    vq = _perturbed(build_vqvae_from_ref(VQ_DICT, device="cpu", seed=3), 4)
    vq_ckpt = _save(vq, tmp_path / "vq.ckpt")
    flows = _flow_dict(True)
    flow = _perturbed(IDFlow(FlowCfg.from_ref(flows), device="cpu", seed=5),
                      6)
    cfg_path = _write_yaml(tmp_path / "res.yaml", dict(train=dict(
        trainer="ResidualTrainer", flows=flows,
        vqvae={**VQ_DICT, "checkpoint": vq_ckpt}, input_size=[16, 16])))
    return cfg_path, _save(flow, tmp_path / "res.ckpt")


def test_residual_config_roundtrip(plain_ckpt, tmp_path):
    """On a ResidualTrainer config the .lic carries the VQ index stream and
    the conditional residual containers and decodes exactly with no side
    information (a 30x18 image: 2x2 image tiles of 16x16); a plain .lic is
    refused by the residual config, and a residual one by the plain
    config.  Tolerance: exact."""
    cfg_path, ckpt = _residual_setup(tmp_path)
    img = _img(5, (30, 18, 3))
    src = str(tmp_path / "r.npy")
    np.save(src, img)
    args = _args(ckpt, tmp_path, "--no-stored-fallback", config=cfg_path)
    C.main(["compress", "--input", src] + args)
    h, blobs = _header(tmp_path / "r.lic")
    assert h["pipeline"] == "residual"
    assert h["chunks"] == [{"nseg": 3, "info": {"batch": 16, "images": 4}}]
    assert blobs.startswith(b"VQIX")
    C.main(["decompress", "--input", str(tmp_path / "r.lic"), "--ext",
            ".npy"] + args)
    assert np.array_equal(np.load(tmp_path / "r.npy"), img)

    s = str(tmp_path / "s.npy")
    np.save(s, _img(6, (16, 16, 3)))
    C.main(["compress", "--input", s]
           + _args(plain_ckpt, tmp_path, "--no-stored-fallback"))
    with pytest.raises(SystemExit):
        C.main(["decompress", "--input", str(tmp_path / "s.lic")] + args)
    with pytest.raises(SystemExit):
        C.main(["decompress", "--input", str(tmp_path / "r.lic")]
               + _args(plain_ckpt, tmp_path))


def test_dtype_bfloat16(plain_ckpt, tmp_path):
    """--dtype bfloat16 round-trips under itself, and its container is
    refused by the float32 pipeline.  Tolerance: exact."""
    img = _img(17, (16, 16, 3))
    src = str(tmp_path / "d.npy")
    np.save(src, img)
    args = _args(plain_ckpt, tmp_path, "--no-stored-fallback", "--ext",
                 ".npy")
    C.main(["compress", "--input", src, "--dtype", "bfloat16"] + args)
    C.main(["decompress", "--input", str(tmp_path / "d.lic"), "--dtype",
            "bfloat16"] + args)
    assert np.array_equal(np.load(tmp_path / "d.npy"), img)
    with pytest.raises(SystemExit, match="different model"):
        C.main(["decompress", "--input", str(tmp_path / "d.lic")] + args)


def test_needs_cuda_unless_cpu(plain_ckpt, tmp_path, monkeypatch):
    """Without CUDA and without --device cpu, loading the model raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _args(plain_ckpt, tmp_path) if a not in ("--device",
                                                               "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.main(["compress", "--input", "x.npy"] + args)
