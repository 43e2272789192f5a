"""A published `TwoLevelFlows` entry cut to a size the CPU codes in
seconds: 30x22 images padded to 32x24, a rough flow over 4x3 (no squeeze)
and a fine flow over 8x8 tiles squeezed to 4x4x12, two flows, DenseBlocks
of growth 8 and depth 2."""

from __future__ import annotations

import copy


def _flow(h: int, w: int, scale: int) -> dict:
    nn = {"name": "DenseBlock", "growth_channel": 8, "depth": 2,
          "layer": {"name": "DenseLayer", "act": "ReLU"}}
    rnd = {"name": "Round", "nbits": 8}
    return {"name": "IDFlows", "nflows": 2, "nbits": 8, "nsplit": 1,
            "H": h, "W": w, "C": 3,
            "couple": {"name": "AdditiveCouple", "split": 0.75,
                       "nn": copy.deepcopy(nn), "round": rnd},
            "extenddim": {"name": "ExtendDim", "scale": scale},
            "prior": {"name": "Prior", "round": rnd, "nn": copy.deepcopy(nn)},
            "distribution": {"name": "DLogistic"}, "round": rnd}


def tiny_twolevel_model() -> dict:
    return {"name": "TwoLevelFlows", "H": 30, "W": 22, "C": 3, "pad": [2, 2],
            "fine_flows": _flow(8, 8, 2), "rough_flows": _flow(4, 3, 1),
            "batchsize": 256}
