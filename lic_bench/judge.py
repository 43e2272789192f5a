"""The comparisons that decide `correct`: what the timed path produced
against the plain float32 reference (`reference/`), number by number.

Codec cells.  The containers of a sample of the window's queues are read
with the frozen reader (`reference/rans.py`) under the program's own
priors, which the program's public model gives on the same images: the
bins read must equal the program's latents, symbol for symbol, with every
stream's state invariant holding (`container_symbols_off`,
`container_streams_bad`: exact).  So the containers carry exactly those
latents under exactly those priors.  Those latents are then held against
the reference's, computed from the image alone (`latents_off_ppm`: the
share of latents that differ, in parts per million: float rounding flips
a few roundings of coupling shifts), and the program's priors against the
reference's prior evaluated on the program's own kept half
(`prior_gap`: the widest gap, max(|mean gap| / scale, |logscale gap|)).
The reference follows the program's kept half level by level there,
because a rounding flip upstream changes the input of every prior
downstream; `latents_off_ppm` checks the whole chain from the image.

Train cells.  The program's first two calls (eight updates) against the
plain step's eight from the seeded weights, and one more call of the
window's own step after the window against the plain step's four from the
state the window left (the program's: the reference follows it there,
names ending `.late`).  Each step's loss (`loss_gap`: the widest relative
gap; `loss_gap.first`: the first step's), and the change of Adamax's first
moment (`moment_gap`) and of the parameters (`change_gap`) over the steps,
each by the worst leaf: the gap between the two norms over the larger of
the reference's norm of that leaf and the median leaf's; `.median` names
the median over the leaves.  `change_gap` leaves out leaves whose first
reference gradient is under a thousandth of the median leaf's: Adamax
moves those by round-off.  A number that the cell's limits file does not
name is printed as a note and not judged.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import rans
from .reference.flow import Flow
from .reference.vqvae import VQVAE


def codec_numbers(ref: Flow, images: Sequence[torch.Tensor], levels,
                  blobs=None, conds=None) -> Dict[str, float]:
    """images[b]: a batch (NHWC); levels[b]: the judged side's (z, keep,
    mean, logscale) per level on it; blobs[b]: its containers, level 0
    first (None: a side that wrote none, such as the control); conds[b]:
    a conditional flow's conditioning image."""
    sym_off = bad = off = total = 0
    gap = 0.0
    with torch.no_grad():
        for b, x in enumerate(images):
            lv = levels[b]
            cond = None if conds is None else conds[b]
            feats = ref.cond_features(cond)
            judged = [torch.round(z * 256.0).to(torch.int64).reshape(-1)
                      for z, _, _, _ in lv]
            if blobs is not None:
                bins, ok = rans.decode_chain(
                    blobs[b], [(m.reshape(-1), ls.reshape(-1))
                               for _, _, m, ls in lv])
                sym_off += sum(int((r != j).sum())
                               for r, j in zip(bins, judged))
                bad += 0 if ok else 1
                judged = bins
            r = ref.forward(x, cond)
            for li, ((zr, _, _, _), j) in enumerate(zip(r, judged)):
                off += int((torch.round(zr * 256.0).to(torch.int64)
                            .reshape(-1) != j).sum())
                total += j.numel()
                z, keep, mean, logscale = lv[li]
                last = keep is None
                mr, lr = ref.prior(z if last else keep, li, feats[li])
                g = torch.maximum((mean - mr).abs() / torch.exp(lr),
                                  (logscale - lr).abs())
                gap = max(gap, float(g.max()))
    out = {"latents_off_ppm": off / max(total, 1) * 1e6, "prior_gap": gap}
    if blobs is not None:
        out = {"container_symbols_off": float(sym_off),
               "container_streams_bad": float(bad), **out}
    return out


def residual_numbers(vq: VQVAE, ref: Flow, images, indices, recs,
                     sampled) -> Dict[str, float]:
    """The residual codec's numbers: `index_off_ppm`, the judged side's VQ
    indices (as its index streams carry them) against the reference
    encoder's nearest codewords, and `rec_off_ppm`, its conditioning
    reconstruction against the reference decoder's of the same indices,
    over every distinct batch (images[i], indices[i], recs[i]); then the
    flow's numbers (`codec_numbers`) over the sampled requests, each
    (x, rec, levels, blobs): the residual x - rec conditioned on rec (the
    judged side's: the reference follows it there)."""
    idx_off = rec_off = n_idx = n_rec = 0
    with torch.no_grad():
        for x, idx, rec in zip(images, indices, recs):
            idx_off += int((vq.indices(x) != idx).sum())
            n_idx += idx.numel()
            rec_off += int((vq.reconstruction(idx) != rec).sum())
            n_rec += rec.numel()
    out = {"index_off_ppm": idx_off / n_idx * 1e6,
           "rec_off_ppm": rec_off / n_rec * 1e6}
    blobs = [s[3] for s in sampled]
    out.update(codec_numbers(ref, [x - r for x, r, _, _ in sampled],
                             [lv for _, _, lv, _ in sampled],
                             None if blobs[0] is None else blobs,
                             [r for _, r, _, _ in sampled]))
    return out


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of the reference's norm of
    that leaf and the median leaf's."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].float())) for k in keep}
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keep}
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}


def train_numbers(ref, start: dict, losses: Sequence[float], judged: dict,
                  late: str = "", where: Dict[str, str] = None
                  ) -> Dict[str, float]:
    """ref: a `reference.train.PlainTrainer` that took the same steps from
    `start`; start and judged: the state both sides started from and the
    judged side's after those steps, each {"params", "m"} (Adamax's first
    moments; host or device tensors, by leaf name; an optimizer that never
    stepped holds none: zero); losses: the judged side's per-step losses.
    `late` suffixes the names.  Each leaf measure is the parameters' or
    the first moments' change over the steps; beside its worst leaf, its
    median over the leaves; `where` gets the worst leaf of each."""
    dev = next(iter(ref.params.values())).device
    names = list(ref.params)

    def leaves(state, key):
        return {k: state[key][k].to(dev) if k in state[key]
                else torch.zeros_like(ref.params[k]) for k in names}

    p0, m0 = leaves(start, "params"), leaves(start, "m")
    p1, m1 = leaves(judged, "params"), leaves(judged, "m")
    if len(losses) != len(ref.losses):
        raise ValueError(f"{len(losses)} losses against {len(ref.losses)}")
    gaps = [abs(p - r) / abs(r) for p, r in zip(losses, ref.losses)]
    g = {k: float(torch.linalg.vector_norm(ref.first_grads[k]))
         for k in names}
    g_med = float(np.median(list(g.values())))
    moving = [k for k in names if g[k] >= 1e-3 * g_med]
    d_prog = {k: p1[k] - p0[k] for k in names}
    d_ref = {k: ref.params[k].detach() - p0[k] for k in names}
    dm_prog = {k: m1[k] - m0[k] for k in names}
    dm_ref = {k: ref.m[k] - m0[k] for k in names}
    out = {"loss_gap" + late: max(gaps), "loss_gap.first" + late: gaps[0]}
    for name, prog, refd, keep in (("moment_gap", dm_prog, dm_ref, names),
                                   ("change_gap", d_prog, d_ref, moving)):
        leaf = _leaf_gaps(prog, refd, keep)
        worst = max(leaf, key=leaf.get)
        out[name + late] = leaf[worst]
        out[name + ".median" + late] = float(np.median(list(leaf.values())))
        if where is not None:
            where[name + late] = worst
    return out
