"""Plain float32 two-level pyramid codec model: the reference the benchmark
judges the port's `TwoLevelFlows` by.

Written from the published description (lym01803/FinalProject-
LosslessImageCompression, `configs/config_twolevel.yaml`, the
`TwoLevelFlows` model of `models/twolevel.py`):

- the image [B, H, W, C] is replication-padded by `pad` = (rows, columns)
  at the bottom and the right;
- the padded image is average-pooled to the rough flow's (H, W) by
  torch's adaptive windows [floor(i * In / Out), ceil((i + 1) * In / Out))
  (`F.adaptive_avg_pool2d`) and rounded to the 1/2^nbits grid: the rough
  image, which the rough flow codes;
- the rough image is upsampled to the padded size by the same windows with
  the roles swapped (`F.adaptive_avg_pool2d` to the larger size), and the
  residual is the padded image less it;
- the residual is cut into tiles of the fine flow's (H, W), row-major over
  the tile grid, image by image: the fine flow codes them all as one batch.

The two flows are `reference.flow.Flow` instances on their own weights
(each a flat dict named as the package's IDFlow state_dict names it).
Tensors are NHWC as in the package under test.  The module imports
nothing of the package under test and no JAX.

Departures from the published model:
- it takes only geometries where the rough size divides the padded size
  and the tile size divides the padded size, as `config_twolevel` has
  (216 x 184 over 27 x 23 and 8 x 8); the upsampling is then a
  replication and the residual stays on the grid, so no further padding
  is needed and none is modelled;
- the published `batchsize` key (the fine flow's tiles per chunk in
  training) plays no part: all tiles of a batch go through the fine flow
  as one batch, which changes no number;
- `precision="tf32"` runs both flows in TF32 (`reference.flow.Flow`), the
  comparison's control; the split itself stays float32 and exact.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .flow import Arch, Flow, arch, param_shapes


def arches(model: dict) -> Tuple[Arch, Arch]:
    """(rough, fine) architectures of a published `TwoLevelFlows` entry."""
    return arch(model["rough_flows"]), arch(model["fine_flows"])


def shapes(model: dict) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Each sub-flow's weights by the package's names, without its prefix:
    {"rough": {...}, "fine": {...}}."""
    rough, fine = arches(model)
    return {"rough": param_shapes(rough), "fine": param_shapes(fine)}


class TwoLevel:
    """The pyramid over a published `TwoLevelFlows` entry and the two
    sub-flows' weight dicts."""

    def __init__(self, model: dict, rough_w: Dict[str, torch.Tensor],
                 fine_w: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        self.H, self.W, self.C = model["H"], model["W"], model.get("C", 3)
        self.pad = tuple(model.get("pad", (0, 0)))
        self.nbits = model.get("nbits", 8)
        ra, fa = arches(model)
        self.Hp, self.Wp = self.H + self.pad[0], self.W + self.pad[1]
        self.rough_hw, self.tile_hw = (ra.H, ra.W), (fa.H, fa.W)
        for n, (r, t) in zip((self.Hp, self.Wp), zip(self.rough_hw,
                                                     self.tile_hw)):
            if n % r or n % t:
                raise ValueError(
                    f"padded {self.Hp}x{self.Wp} over rough "
                    f"{self.rough_hw} and tiles {self.tile_hw}: only sizes "
                    "that both divide are modelled")
        self.rough = Flow(ra, rough_w, precision)
        self.fine = Flow(fa, fine_w, precision)

    def split(self, x: torch.Tensor):
        """NHWC batch on the grid -> (rough image [B, rh, rw, C], tiles
        [B x the tiles of an image, th, tw, C])."""
        with torch.no_grad():
            h = x.permute(0, 3, 1, 2)
            if any(self.pad):
                h = F.pad(h, (0, self.pad[1], 0, self.pad[0]),
                          mode="replicate")
            bins = float(2 ** self.nbits)
            rough = torch.round(F.adaptive_avg_pool2d(h, self.rough_hw)
                                * bins) / bins
            up = F.adaptive_avg_pool2d(rough, (self.Hp, self.Wp))
            res = (h - up).permute(0, 2, 3, 1)
            b, (th, tw) = x.shape[0], self.tile_hw
            tiles = res.reshape(b, self.Hp // th, th, self.Wp // tw, tw,
                                self.C).permute(0, 1, 3, 2, 4, 5)
            return (rough.permute(0, 2, 3, 1).contiguous(),
                    tiles.reshape(-1, th, tw, self.C).contiguous())
