"""`BENCHMARK.json` against the contract's shapes, every cell's files
present, the import check by whole top-level names, and a run refusing to
start without a card."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest

from lic_bench import run
from lic_bench.tests.tiny import BENCH, ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return load(ROOT, "BENCHMARK.json")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert 1 <= bench["run_seconds"] <= 51
    assert len(bench["command"]) <= 32 and all(map(_line, bench["command"]))
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("lic_bench/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_sources_bounds_and_layers(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells and c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:  # every cell reports setup_s, one more, one per-layer
        assert sum(c in m.get("workloads", cells) for m in e2e.values()) >= 2
        assert any(c in m["workloads"] for m in bench["per_layer"])


def test_every_cell_and_metric_finds_its_files(bench):
    for w in bench["workloads"]:
        traffic = load(BENCH, "traffic", w["traffic"] + ".json")
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           traffic["kind"] + ".py"))
        limits = load(BENCH, "limits", w["name"] + ".json")
        assert limits and all(v >= 0 for v in limits.values())
    for m in bench["per_layer"]:
        reader = run.metric_reader(m["name"])
        assert reader.MOVES == m["moves"] and callable(reader.read)


def test_import_check_compares_whole_top_level_names():
    found = run.forbidden_modules([
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
        "finalproject_losslessimagecompression_tpu",
        "finalproject_losslessimagecompression_tpu.codec",
        "finalproject_losslessimagecompression_tpu_torch",
        "finalproject_losslessimagecompression_tpu_torch.models.exact",
        "jaxtyping", "flaxen", "numpy"])
    assert found == ["finalproject_losslessimagecompression_tpu",
                     "finalproject_losslessimagecompression_tpu.codec",
                     "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]


def test_harness_and_the_port_it_drives_load_no_jax():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['x']\n"
        "import lic_bench.run as r, lic_bench.control\n"
        "import lic_bench.drivers.bulk, lic_bench.drivers.train\n"
        "from finalproject_losslessimagecompression_tpu_torch.models import "
        "exact, idflow\n"
        "from finalproject_losslessimagecompression_tpu_torch.train import "
        "trainer, optim\n"
        "print(r.forbidden_modules(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_prints_nothing_and_fails():
    out = subprocess.run(
        [sys.executable, "lic_bench/run.py", "--workload", "imagenet64.bulk",
         "--seed", str(2 ** 35), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
