"""The PyTorch port's entropy coder held against the JAX package.

Inputs are drawn with numpy and handed to both packages.  `exp` is not
bit-equal between torch and XLA, so byte-level parity is asserted on
agreement-filtered symbols (every CDF value of the symbol's 2049-position
window, and exp(logscale), agree between the two backends); wider scales are
held by the state-loop algebra on shared (c_start, freq) tiles.  The CUDA
kernels cannot run here: their wrappers take the plain path for CPU tensors,
and chip_smoke.py holds the kernels against that plain path on the card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from finalproject_losslessimagecompression_tpu.codec import cdf as jcdf
from finalproject_losslessimagecompression_tpu.codec import coder as jcoder
from finalproject_losslessimagecompression_tpu.codec import container as jcont
from finalproject_losslessimagecompression_tpu.codec import interleaved as JIL
from finalproject_losslessimagecompression_tpu.codec.pallas_rans import (
    pallas_decode_core,
    pallas_encode_core,
)
from finalproject_losslessimagecompression_tpu_torch.codec import coder
from finalproject_losslessimagecompression_tpu_torch.codec import container
from finalproject_losslessimagecompression_tpu_torch.codec import (
    interleaved as IL,
)
from finalproject_losslessimagecompression_tpu_torch.codec.cdf import (
    NBINS,
    cdf_bits,
    lower_bin,
)
from finalproject_losslessimagecompression_tpu_torch.codec.cuda_rans import (
    MAX_DECODE_STREAMS,
    check_streams,
    decode_launch_shape,
    rans_cdf_prepass,
    rans_decode,
    rans_encode,
)

torch.set_num_threads(2)  # the suite runs several workers at once
# a process's first parallel CPU exp can be inaccurate (test_torch_flow.py)
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "finalproject_losslessimagecompression_tpu_torch"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _exp_both(logscale):
    return (torch.exp(_t(logscale)).numpy(),
            np.asarray(jax.jit(jnp.exp)(logscale)))


def _agreeing_symbols(rng, n):
    """n symbols (v, mean, logscale) whose scale and whole-window CDF agree
    bit for bit between torch and XLA.  Scales are log-uniform in
    [1e-3, 3e-2]; v is a logistic sample around the mean."""
    m = 3 * n
    means = rng.normal(0.0, 1.0, m).astype(np.float32)
    logscales = rng.uniform(np.log(1e-3), np.log(3e-2), m).astype(np.float32)
    s_t, s_j = _exp_both(logscales)
    keep = s_t == s_j
    low = jcdf.lower_bin(means)
    pos = low[:, None] + np.arange(-1, NBINS, dtype=np.int32)[None, :]
    shape = pos.shape
    ct = cdf_bits(_t(pos), _t(np.broadcast_to(means[:, None], shape)),
                  _t(np.broadcast_to(s_t[:, None], shape)),
                  _t(np.broadcast_to(low[:, None], shape))).numpy()
    cj = np.asarray(jcdf.cdf_bits_jnp(pos, means[:, None], s_j[:, None],
                                      low[:, None])).astype(np.int64)
    keep &= np.all(ct == cj, axis=1)
    idx = np.nonzero(keep)[0][:n]
    assert idx.size == n, "too few agreeing symbols drawn"
    means, logscales = means[idx], logscales[idx]
    raw = means + s_t[idx] * rng.logistic(0, 1, n).astype(np.float32)
    v = np.round(raw * 256).astype(np.int32)
    return v, means, logscales


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


# modules the import check must reach (it walks the whole package)
MUST_WALK = (
    "codec.cuda_rans", "models.exact", "train.trainer", "cli.codec",
    "parallel.multiproc", "utils.graphs", "utils.png", "demo",
    "demo.make_corpus", "demo.stress", "demo.eval_phases",
    "demo.filecodec_demo",
)


def test_port_imports_no_jax(tmp_path):
    """Every port module (the whole package, walked with pkgutil) and the
    root chip scripts import without jax, flax or the JAX package (checked
    in a fresh interpreter).  In the same
    interpreter yaml, PIL, msgpack, optax and tensorboard -- packages the
    card's machine does not have -- are blocked at import; the training
    CLI still trains one CPU step with eval coding and saves, and a JAX
    msgpack checkpoint that this process wrote with flax loads into the
    port's IDFlow with the same weights."""
    from finalproject_losslessimagecompression_tpu import models as JM
    from finalproject_losslessimagecompression_tpu.train import (
        checkpoint as jckpt,
    )
    from finalproject_losslessimagecompression_tpu_torch.convert import (
        params_from_flax,
    )

    nn = JM.DenseBlockCfg(8, 2, "ReLU")
    cfg_args = "H=16, W=16, C=3, nflows=1, nsplit=2"
    jm = JM.IDFlow(JM.FlowCfg(H=16, W=16, C=3, nflows=1, nsplit=2,
                              couple=JM.CouplingCfg(0.75, nn), prior_nn=nn))
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 16, 16, 3))))
    jpath = str(tmp_path / "flow.msgpack")
    jckpt.save_checkpoint(jpath, {"params": params, "step": 5})
    want = sum(float(v.double().sum()) for v in
               params_from_flax(params).values())
    # every module of the package, found by walking it in the checking
    # interpreter itself (a package that fails to import raises), and the
    # root chip scripts
    walk = (
        "import importlib, pkgutil\n"
        f"import {PORT}\n"
        "def _fail(name):\n"
        "    raise ImportError(name)\n"
        f"mods = [m.name for m in pkgutil.walk_packages({PORT}.__path__, "
        f"{PORT!r} + '.', onerror=_fail)]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"want = {[f'{PORT}.{m}' for m in MUST_WALK]!r}\n"
        "assert set(want) <= set(mods), sorted(set(want) - set(mods))\n"
        "import chip_smoke, chip_decode_variants, chip_profile_read\n"
        "import chip_dense_compare\n"
    )
    blocked = ("yaml", "PIL", "msgpack", "optax", "tensorboard",
               "tensorflow")
    sets = ["max_step=1", "step_per_epoch=1", "evaluate_interval=1",
            "save_interval=1", "max_eval_batches=1", "num_streams=64",
            f"save_path={tmp_path / 'm.ckpt'}",
            f"writer_path={tmp_path / 'log'}"]
    argv = ["--config", os.path.join(REPO, "configs", "smoke_synthetic.yaml"),
            "--device", "cpu"] + [a for kv in sets
                                  for a in ("--set", "train." + kv)]
    check = (
        "bad = [m for m, mod in sys.modules.items() if mod is not None and "
        "m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        f"'finalproject_losslessimagecompression_tpu') + {blocked!r}]\n"
        "assert not bad, bad\n"
    )
    code = (
        "import sys\n"
        # a None entry makes `import name` raise ImportError and
        # importlib.util.find_spec(name) report the package missing
        + "".join(f"sys.modules[{b!r}] = None\n" for b in blocked)
        + walk
        + check
        + f"t = {PORT}.cli.train.main({argv!r})\n"
        "assert t.step == 1 and t.writer._tb is None\n"
        f"from {PORT} import models as TM\n"
        f"from {PORT}.convert import params_from_flax\n"
        f"from {PORT}.train.checkpoint import load_checkpoint\n"
        "nn = TM.DenseBlockCfg(8, 2, 'ReLU')\n"
        f"m = TM.IDFlow(TM.FlowCfg({cfg_args}, couple=TM.CouplingCfg(0.75, "
        "nn), prior_nn=nn), device='cpu')\n"
        f"st = load_checkpoint({jpath!r}, 'cpu', params_from_flax)\n"
        "m.load_state_dict(st['params'])\n"
        "assert st['step'] == 5\n"
        "print(repr(sum(float(v.double().sum()) for v in "
        "m.state_dict().values())))\n"
        + check
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout.splitlines()[-1]) == want
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        tags = {json.loads(line)["tag"]: json.loads(line)["value"]
                for line in f}
    assert tags["coding errors"] == 0 and "train loss" in tags
    assert os.path.exists(tmp_path / "m.ckpt")


# ---------------------------------------------------------------------------
# CDF
# ---------------------------------------------------------------------------


def test_cdf_agreement_with_jnp_and_np():
    """Port cdf_bits against cdf_bits_jnp and cdf_bits_np over 1e5 draws
    (means ~ N(0, 1), scales exp(U(-6.24, 1)), v anywhere in the window).
    Tolerance: the integer term (window lower bound, v - lower + 1) exact;
    the CDF within 4 counts of 2^24; agreement >= 98% with jnp, the backend
    whose containers the port is compared with (measured 99.5%), and >= 97%
    with numpy (measured 97.9%): exp differs by an ulp from torch's on 9.6%
    of float32 inputs in XLA and on 39% in numpy."""
    rng = np.random.default_rng(11)
    n = 100_000
    means = rng.normal(0.0, 1.0, n).astype(np.float32)
    scales = np.exp(rng.uniform(-6.24, 1.0, n)).astype(np.float32)
    low_j = jcdf.lower_bin(means)
    low_t = lower_bin(_t(means)).numpy()
    assert np.array_equal(low_t, low_j)
    v = (low_j - 1 + rng.integers(0, NBINS + 1, n)).astype(np.int32)
    ct = cdf_bits(_t(v), _t(means), _t(scales), _t(low_t)).numpy()
    cj = np.asarray(jcdf.cdf_bits_jnp(v, means, scales, low_j)).astype(np.int64)
    cn = jcdf.cdf_bits_np(v, means, scales, low_j).astype(np.int64)
    for name, ref, floor in (("jnp", cj, 0.98), ("np", cn, 0.97)):
        assert np.max(np.abs(ct - ref)) <= 4
        agree = float(np.mean(ct == ref))
        print(f"torch-vs-{name} CDF agreement: {agree:.5f}")
        assert agree >= floor
    # with equal window bounds the integer term v - lower + 1 is equal, so
    # what is left of each CDF is its rounded sigmoid term, in [0, M - 2048]
    for c in (ct, cj):
        part1 = c - (v.astype(np.int64) - low_j + 1)
        assert part1.min() >= 0 and part1.max() <= (1 << 24) - NBINS


# ---------------------------------------------------------------------------
# state-loop algebra on shared tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seeded", [False, True])
def test_encode_state_loop_matches_scan(seeded):
    """Port encode_state_loop against jax.lax.scan(_encode_step) on the same
    numpy (c_start, freq) tiles at wide scales (up to e^1).  Tolerance:
    words, flags and final (hi, lo) bit-identical."""
    rng = np.random.default_rng(3 + seeded)
    k, S = 64, 96
    means = rng.normal(0.0, 2.0, (k, S)).astype(np.float32)
    scales = np.exp(rng.uniform(-6.0, 1.0, (k, S))).astype(np.float32)
    low = jcdf.lower_bin(means)
    v = np.clip(np.round((means + scales * rng.logistic(0, 1, (k, S))) * 256),
                low, low + NBINS - 1).astype(np.int32)
    c0 = jcdf.cdf_bits_np(v - 1, means, scales, low)
    f = jcdf.cdf_bits_np(v, means, scales, low) - c0
    seeds = (rng.integers(0, 2**32, S, dtype=np.uint64).astype(np.uint32)
             if seeded else np.zeros(S, np.uint32))
    (hi, lo), (words, flags) = jax.lax.scan(
        JIL._encode_step, (jnp.ones(S, jnp.uint32), jnp.asarray(seeds)),
        (jnp.asarray(c0), jnp.asarray(f)))
    tw, tf, thi, tlo = IL.encode_state_loop(
        _t(c0.astype(np.int64)), _t(f.astype(np.int64)),
        _t(seeds.astype(np.int64)) if seeded else None)
    assert np.array_equal(tw.numpy(), np.asarray(words).astype(np.int64))
    assert np.array_equal(tf.numpy(), np.asarray(flags))
    assert np.array_equal(thi.numpy(), np.asarray(hi).astype(np.int64))
    assert np.array_equal(tlo.numpy(), np.asarray(lo).astype(np.int64))
    assert tf.numpy().any()  # renormalisation was exercised


# ---------------------------------------------------------------------------
# kernel modules (the wrappers' plain path) against the Pallas kernels
# ---------------------------------------------------------------------------


def _kernel_tiles(seed, S=128, k=16):
    rng = np.random.default_rng(seed)
    n = S * k - 40  # a padded tail
    v, means, logscales = _agreeing_symbols(rng, n)
    s_t, _ = _exp_both(logscales)
    m = IL._layout(_t(means), n, S, k, IL.PAD_MEAN)
    s = IL._layout(_t(s_t), n, S, k, IL.PAD_SCALE)
    lower = lower_bin(m)
    vv = IL._layout(_t(v), n, S, k, IL.PAD_VALUE)
    vv = torch.minimum(torch.maximum(vv, lower), lower + NBINS - 1)
    seeds = rng.integers(0, 2**32, S, dtype=np.uint64).astype(np.uint32)
    return vv, m, s, lower, seeds


@pytest.mark.parametrize("seeded", [False, True])
def test_encode_wrapper_matches_pallas_encode(seeded):
    """rans_encode (CPU tensors: the plain path) against
    pallas_encode_core in interpret mode, S=128, k=16, on agreement-filtered
    symbols.  Tolerance: words, flags, hi, lo bit-identical.  The launch
    counter stays 0: no kernel ran."""
    vv, m, s, lower, seeds = _kernel_tiles(21 + seeded)
    k, S = vv.shape
    before = rans_encode.launches
    tw, tf, thi, tlo = rans_encode(
        vv, m, s, lower, _t(seeds.astype(np.int64)) if seeded else None)
    assert rans_encode.launches == before
    with pltpu.force_tpu_interpret_mode():
        jw, jf, jhi, jlo = pallas_encode_core(
            jnp.asarray(vv.numpy()), jnp.asarray(m.numpy()),
            jnp.asarray(s.numpy()), jnp.asarray(lower.numpy()), S, k,
            jnp.asarray(seeds) if seeded else None)
    assert np.array_equal(tw.numpy().reshape(-1),
                          np.asarray(jw).astype(np.int64))
    assert np.array_equal(tf.numpy().reshape(-1), np.asarray(jf))
    assert np.array_equal(thi.numpy(), np.asarray(jhi).astype(np.int64))
    assert np.array_equal(tlo.numpy(), np.asarray(jlo).astype(np.int64))


@pytest.mark.parametrize("windowed", [False, True])
def test_decode_wrapper_matches_pallas_decode(windowed):
    """rans_decode (plain path) against pallas_decode_core in interpret
    mode, resident and windowed, S=128, k=16, seeded streams.  Tolerance:
    values and final states bit-identical; values equal the input and the
    states return to 2^32 | seed."""
    vv, m, s, lower, seeds = _kernel_tiles(31)
    k, S = vv.shape
    seeds_t = _t(seeds.astype(np.int64))
    enc = IL.interleaved_encode(vv.reshape(-1), m.reshape(-1), s.reshape(-1),
                                num_streams=S, seeds=seeds_t,
                                sym_per_stream=k)
    buf, total, hi, lo = enc.words, enc.num_words, enc.state_hi, enc.state_lo
    before = rans_decode.launches
    tv, thi, tlo = rans_decode(buf, total, hi, lo, m, s, lower)
    assert rans_decode.launches == before
    assert torch.equal(tv, vv)
    assert np.all(thi.numpy() == 1)
    assert np.array_equal(tlo.numpy(), seeds.astype(np.int64))
    with pltpu.force_tpu_interpret_mode():
        jv, jhi, jlo = pallas_decode_core(
            jnp.asarray(buf.numpy().astype(np.uint32)),
            jnp.int32(int(total)), jnp.asarray(hi.numpy().astype(np.uint32)),
            jnp.asarray(lo.numpy().astype(np.uint32)), jnp.asarray(m.numpy()),
            jnp.asarray(s.numpy()), jnp.asarray(lower.numpy()), S, k,
            windowed=windowed)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(thi.numpy(), np.asarray(jhi).astype(np.int64))
    assert np.array_equal(tlo.numpy(), np.asarray(jlo).astype(np.int64))


# ---------------------------------------------------------------------------
# containers across packages
# ---------------------------------------------------------------------------


def _with_escapes(v, means, positions):
    v = v.copy()
    for j, p in enumerate(positions):
        low = int(jcdf.lower_bin(means[p]))
        v[p] = low + NBINS + 300 if j % 2 == 0 else low - 77
    return v


def test_containers_byte_identical_across_packages():
    """On agreement-filtered symbols the port's containers equal the JAX
    package's byte for byte -- an unseeded donor with a donated hole and
    out-of-window escapes, and a seeded container -- and each package
    decodes the other's.  Tolerance: bytes identical, decodes exact."""
    rng = np.random.default_rng(41)
    nA, nB, S = 3000, 1024, 16
    vA, mA, lA = _agreeing_symbols(rng, nA)
    vA = _with_escapes(vA, mA, [3, 100, 2999])
    vB, mB, lB = _agreeing_symbols(rng, nB)
    latA, latB = vA / np.float32(256), vB / np.float32(256)

    # port: A unseeded; B seeded from A's first S words; A donates them
    eA = coder.encode_tensor_deferred(_t(latA), _t(mA), _t(lA), S)
    seeds = IL.make_seeds(eA.words, eA.num_words, S)
    eB = coder.encode_tensor_deferred(_t(latB), _t(mB), _t(lB), S, seeds)
    eA.donated = S
    tA, tB = container.pack_streams_many([eA, eB])
    # JAX package, same chain
    jA = jcoder.encode_tensor_deferred(latA, mA, lA, S)
    jseeds = JIL.make_seeds(jA.words, jA.num_words, S)
    jB = jcoder.encode_tensor_deferred(latB, mB, lB, S, jseeds)
    jA.donated = S
    kA, kB = jcont.pack_streams_many([jA, jB])
    assert tA == kA and tB == kB
    assert eA.oow_count == 3

    # each side decodes the other's containers: B first (its final lo
    # limbs are A's donated words), then A with its hole filled
    xB, okB, loB = coder.decode_streams_deferred(
        container.unpack_streams(kB), _t(mB), _t(lB), tail_start=S)
    xA, okA, _ = coder.decode_streams_deferred(
        container.unpack_streams(kA), _t(mA), _t(lA), fill=loB)
    assert bool(okA) and bool(okB)
    assert np.array_equal(xA.numpy(), latA) and np.array_equal(xB.numpy(),
                                                                latB)
    yB, okB, loB = jcoder.decode_streams_deferred(
        jcont.unpack_streams(tB), mB, lB, tail_start=S)
    yA, okA, _ = jcoder.decode_streams_deferred(
        jcont.unpack_streams(tA), mA, lA, fill=loB)
    assert bool(okA) and bool(okB)
    assert np.array_equal(np.asarray(yA), latA)
    assert np.array_equal(np.asarray(yB), latB)


def test_encode_tensor_api_byte_identical():
    """encode_tensor (unseeded, one container) equals the JAX package's on
    agreement-filtered symbols, and decode_tensor round-trips both ways.
    Tolerance: bytes identical, decodes exact."""
    rng = np.random.default_rng(43)
    v, m, ls = _agreeing_symbols(rng, 2500)
    lat = (v / np.float32(256)).reshape(10, 10, 25)
    m, ls = m.reshape(lat.shape), ls.reshape(lat.shape)
    blob = coder.encode_tensor(_t(lat), _t(m), _t(ls), num_streams=32)
    assert blob == jcoder.encode_tensor(lat, m, ls, num_streams=32)
    assert np.array_equal(
        coder.decode_tensor(blob, _t(m), _t(ls)).numpy(), lat)
    assert np.array_equal(np.asarray(jcoder.decode_tensor(blob, m, ls)), lat)


# ---------------------------------------------------------------------------
# container faults and the state chain
# ---------------------------------------------------------------------------


def _port_blob(seed, n=800, escapes=(5, 99, 600)):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-4, 4, n).astype(np.float32)
    ls = rng.uniform(-5.0, 0.5, n).astype(np.float32)
    v = np.round((means + np.exp(ls) * rng.logistic(0, 1, n)) * 256)
    low = jcdf.lower_bin(means)
    v = np.clip(v, low, low + NBINS - 1).astype(np.int32)
    v = _with_escapes(v, means, escapes)
    lat = v / np.float32(256)
    return coder.encode_tensor(_t(lat), _t(means), _t(ls), 16), lat, means, ls


def test_port_roundtrip_with_escapes():
    """Port encode -> port decode is exact, out-of-window escapes included.
    Tolerance: exact."""
    blob, lat, m, ls = _port_blob(51)
    assert np.array_equal(
        coder.decode_tensor(blob, _t(m), _t(ls)).numpy(), lat)


def test_container_faults_raise_value_error():
    """Corrupt (every header byte, a sample of payload bytes, every byte of
    an escape block), truncated and bad-magic containers raise ValueError,
    as does a parameter tensor of the wrong size.  Tolerance: exact.

    The payload is flipped in a container without escapes: an escaped
    symbol is coded as a clamped window-edge bin of frequency 1, and two
    such symbols in a row leave word bits that no decoded value depends on
    (the escape patch overwrites the position), so flipping them changes
    nothing the decoder returns."""
    blob, lat, m, ls = _port_blob(53, escapes=())
    rng = np.random.default_rng(0)
    header = list(range(container._HEADER.size))
    end = len(blob) - 4  # the escape count
    payload = rng.choice(np.arange(header[-1] + 1, end), 40,
                         replace=False).tolist()
    for pos in header + payload + list(range(end, len(blob))):
        bad = bytearray(blob)
        bad[pos] ^= 0xFF
        with pytest.raises(ValueError):
            coder.decode_tensor(bytes(bad), _t(m), _t(ls))
    blob_e, _, m_e, ls_e = _port_blob(53)
    for pos in range(len(blob_e) - (8 * 3 + 4), len(blob_e)):
        bad = bytearray(blob_e)
        bad[pos] ^= 0xFF
        with pytest.raises(ValueError):
            coder.decode_tensor(bytes(bad), _t(m_e), _t(ls_e))
    for cut in (0, 3, 8, 15, 23, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ValueError):
            coder.decode_tensor(blob[:cut], _t(m), _t(ls))
    with pytest.raises(ValueError, match="magic"):
        container.unpack_streams(b"LIC1" + blob[4:])
    with pytest.raises(ValueError):
        coder.decode_tensor(blob, _t(m[:-1]), _t(ls[:-1]))


def test_cpp_chain_equals_python_chain():
    """The g++-built state chain equals the plain Python chain, both ways,
    on states of every bit length 33..64.  Tolerance: exact."""
    rng = np.random.default_rng(61)
    S = 300
    nb = rng.integers(33, 65, S)
    states = [(1 << (int(b) - 1)) | int(rng.integers(0, 2**62)) % (
        1 << (int(b) - 1)) for b in nb]
    payload = rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.uint32)
    words_py = [int(w) for w in payload]
    state0_py = container.chain_pack_py(states, words_py)
    buf = np.zeros(50 + 5 * S + 8, np.uint32)
    buf[:50] = payload
    state0, nw = container.chain_pack(np.asarray(states, np.uint64), buf, 50)
    assert state0 == state0_py and nw == len(words_py)
    assert np.array_equal(buf[:nw], np.asarray(words_py, np.uint32))
    back, npay = container.chain_unpack(S, state0, buf[:nw], nw)
    assert npay == 50 and [int(s) for s in back] == states
    assert container.chain_unpack_py(S, state0_py, words_py) == states
    assert words_py == [int(w) for w in payload]
    with pytest.raises(ValueError):
        container.chain_unpack(S, state0, buf[:nw], 3)


def test_kernel_stream_range():
    """The kernels' stream range is checked before any launch: 1..8192
    streams map onto one CTA of at most 1024 threads, and any other count
    raises ValueError, so the card never encodes a container its decode
    kernel cannot read.  Tolerance: exact."""
    assert decode_launch_shape(8) == (32, 1)
    assert decode_launch_shape(768) == (768, 1)
    assert decode_launch_shape(1025) == (544, 2)
    assert decode_launch_shape(MAX_DECODE_STREAMS) == (1024, 8)
    for S in (0, MAX_DECODE_STREAMS + 1):
        with pytest.raises(ValueError):
            check_streams(S)


# ---------------------------------------------------------------------------
# the kernels' redesigned arithmetic, modelled in plain PyTorch / Python
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("logscale", [-6.24, -2.0, 1.0],
                         ids=["tiny", "mid", "wide"])
def test_guided_search_equals_bitwise_search(logscale):
    """The decode kernel's search (inverse-CDF guess, verified bracket,
    gallop and bisection; `IL.guided_search`) returns what the 13-step
    bitwise search `IL._search` returns -- the symbol, CDF(v - 1) and CDF(v)
    -- for mods every 61 counts over [0, 2^24), both ends, and the values
    around CDF(lower - 1) and CDF(lower + 2047) (outside that range only a
    corrupt stream reaches), at means -1, 0.3 and +1; and so does the
    bracket search from random guesses, which exercises every gallop path.
    Tolerance: exact."""
    rng = np.random.default_rng(71)
    means = torch.tensor([-1.0, 0.3, 1.0], dtype=torch.float32)
    scale = torch.exp(torch.tensor(logscale, dtype=torch.float32))
    low = lower_bin(means)
    edges = torch.cat([cdf_bits(low - 1, means, scale, low),
                       cdf_bits(low + NBINS - 1, means, scale, low)])
    mods = torch.cat([torch.arange(0, 1 << 24, 61), torch.tensor(
        [0, 1, (1 << 24) - 1]), (edges[:, None] + torch.arange(-2, 3))
        .reshape(-1).clamp(0, (1 << 24) - 1)])
    mod = mods.repeat(3)
    m = means.repeat_interleave(mods.numel())
    s = torch.full_like(m, float(scale))
    lower = low.repeat_interleave(mods.numel())
    want = IL._search(mod, m, s, lower)
    got = IL.guided_search(mod, m, s, lower)
    for a, b in zip(want, got):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    guess = lower + torch.from_numpy(
        rng.integers(0, NBINS, mod.numel()).astype(np.int32))
    got = IL.bracket_search(mod, m, s, lower, guess)
    for a, b in zip(want, got):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    # the guess is the common case: it hits for nearly every in-range mod
    hit = IL.guess_bin(mod, m, s, lower) == want[0]
    assert float(hit.float().mean()) > 0.99


def test_recip_divmod_exact_at_edges():
    """The encode kernel's division (float64 reciprocal estimate, one
    integer correction; `IL.recip_divmod`) equals Python's exact divmod at
    the edges of its range x < f * 2^40, 1 <= f < 2^24.  Tolerance:
    exact."""
    fs = [1, 2, 3, 255, 4099, (1 << 23) - 1, 1 << 23, (1 << 24) - 2,
          (1 << 24) - 1]
    for f in fs:
        top = f * (1 << 40)
        for x in {0, 1, f - 1, f, 1 << 32, (1 << 32) - 1, (1 << 32) + 1,
                  top - 1, top - f, top - f - 1, (1 << 63) % top,
                  ((1 << 64) - 1) % top}:
            assert IL.recip_divmod(x, f) == divmod(x, f), (x, f)


@settings(max_examples=2000, deadline=None)
@given(f=st.integers(1, (1 << 24) - 1), frac=st.floats(0.0, 1.0))
def test_recip_divmod_exact_property(f, frac):
    """recip_divmod(x, f) == divmod(x, f) for x drawn over [0, f * 2^40)
    (log-uniform in x, so small and large states both appear).  Tolerance:
    exact."""
    x = min(int((f * float(1 << 40)) ** frac), f * (1 << 40) - 1)
    assert IL.recip_divmod(x, f) == divmod(x, f)


def _grouped_tiles(C=3, S=32, k=16, seed=81):
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.uniform(-1, 1, (C, k, S)).astype(np.float32))
    s = torch.from_numpy(np.exp(rng.uniform(-6.24, 1.0, (C, k, S)))
                         .astype(np.float32))
    lower = lower_bin(m)
    v = torch.from_numpy(np.round((m.numpy() + s.numpy() * rng.logistic(
        0, 1, (C, k, S))) * 256).astype(np.int32))
    v = torch.minimum(torch.maximum(v, lower), lower + NBINS - 1)
    seeds = torch.from_numpy(rng.integers(0, 2**32, (C, S)).astype(np.int64))
    return v, m, s, lower, seeds


@pytest.mark.parametrize("kernel", ["prepass", "encode", "decode"])
def test_grouped_wrappers_equal_separate_calls(kernel):
    """A wrapper given C = 3 containers of [C, k, S] tiles (the form one
    launch takes on the card) returns on the CPU what C separate [k, S]
    calls return; the prepass records hold (c_start, freq) of `cdf_tiles`
    and the correctly rounded 1 / freq.  Tolerance: exact."""
    v, m, s, lower, seeds = _grouped_tiles()
    C = v.shape[0]
    if kernel == "prepass":
        rec = rans_cdf_prepass(v, m, s, lower)
        for c in range(C):
            assert torch.equal(rec[c], rans_cdf_prepass(v[c], m[c], s[c],
                                                        lower[c]))
        c_start, freq, recip = IL.unpack_prepass(rec)
        want = IL.cdf_tiles(v, m, s, lower)
        assert torch.equal(c_start, want[0]) and torch.equal(freq, want[1])
        assert torch.equal(recip, 1.0 / freq.to(torch.float64))
        return
    grouped = rans_encode(v, m, s, lower, seeds)
    single = [rans_encode(v[c], m[c], s[c], lower[c], seeds[c])
              for c in range(C)]
    for got, want in zip(grouped, zip(*single)):
        assert torch.equal(got, torch.stack(want))
    if kernel == "encode":
        return
    words, flags, hi, lo = grouped
    buf, total = IL.compact(words, flags)
    for c in range(C):
        b1, t1 = IL.compact(words[c], flags[c])
        assert torch.equal(buf[c], b1) and torch.equal(total[c], t1)
    got = rans_decode(buf, total, hi, lo, m, s, lower)
    for c in range(C):
        want = rans_decode(buf[c], total[c], hi[c], lo[c], m[c], s[c],
                           lower[c])
        for a, b in zip(got, want):
            assert torch.equal(a[c], b)
    assert torch.equal(got[0], v) and torch.equal(got[2], seeds)
