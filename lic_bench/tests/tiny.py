"""Cells of the benchmark cut to a size the CPU runs in seconds: the
published imagenet64 flow at 16x16, two flows a level, DenseBlocks of
growth 8 and depth 2, batches of 4."""

from __future__ import annotations

import copy
import json
import os
import time

import torch

from lic_bench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def tiny_config(name: str = "imagenet64") -> dict:
    """The configuration at 16x16, two flows a level, DenseBlocks 8 x 2; a
    VQ-VAE of 16 codewords of 8, hidden dims 4 / 8 / 8, one ResBlock."""
    cfg = copy.deepcopy(load(BENCH, "configs", name + ".json"))
    m = cfg.get("model") or cfg["flows"]
    m.update(H=16, W=16, nflows=2)
    for k in ("couple", "prior"):
        m[k]["nn"].update(growth_channel=8, depth=2)
    if "vqvae" in cfg:
        cfg["input_size"] = [16, 16]
        cfg["vqvae"].update(embed_num=16, embed_dim=8, hidden_dims=[4, 8, 8])
        for k in ("encoder", "decoder"):
            cfg["vqvae"][k]["block_num"] = 1
    return cfg


def tiny_cell(workload: str, seed: int = 2 ** 33 + 7, seconds: float = 0.5,
              trace: bool = False, chips: int = 0) -> harness.Cell:
    """The workload's cell at the tiny size, on the CPU, with its limits;
    `chips` spreads it over that many ranks (gloo, all on the CPU)."""
    w = {x["name"]: x for x in load(ROOT, "BENCHMARK.json")["workloads"]}[
        workload]
    traffic = load(BENCH, "traffic", w["traffic"] + ".json")
    traffic.update(batch=4)
    if traffic["kind"] == "bulk":
        traffic.update(queue=2, sample_from=2)
    if traffic["kind"] == "request":
        traffic.update(pool=3, sample_from=2, sample_requests=2,
                       trace_requests=2)
    return harness.Cell(w["name"], tiny_config(w["config"]), traffic,
                        load(BENCH, "limits", w["name"] + ".json"),
                        chips or w["chips"], seed, seconds, trace,
                        torch.device("cpu"), time.perf_counter())
