"""The yardstick's arithmetic: nominal FLOPs and bytes of the published
layers, and the reduction of a profiler trace to busy time, kernel times
by name, and idle gaps by host activity.

FLOPs count the published DenseBlock (a 1x1 conv, then a 3x3 conv, then
the 1x1 projection), whatever implements it: a fused or padded
implementation is held to the same count (a frozen copy of the package's
`bench.train_flops_analytic` arithmetic with fusion off).  rANS bytes are
counted at the data's widths from each container's launch shape (S
streams, k steps) and its word count, as the package's kernel table
counts them: the CDF prepass reads bin, mean, scale and window (16 B) and
writes a 16 B record per symbol; the encode reads the record and writes
the words; the decode reads mean, scale and window, writes the bin (16 B)
and reads the words.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .reference.flow import Arch, Block, growths

F32_PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
RANS_KERNELS = ("rans_cdf_prepass_kernel", "rans_encode_kernel",
                "rans_decode_kernel")


def _block(b: Block, c_in: int, out: int, hw: int, backward: bool,
           grad_in: bool) -> int:
    total, ch = 0, c_in
    for i, g in enumerate(growths(b)):
        conv1, conv3 = 2 * hw * ch * ch, 2 * hw * ch * g * 9
        if backward:
            total += (3 if (grad_in or i > 0) else 2) * conv1 + 3 * conv3
        else:
            total += conv1 + conv3
        ch += g
    return total + (3 if backward else 1) * 2 * hw * ch * out


def flow_flops(a: Arch, batch: int, backward: bool) -> int:
    """Conv FLOPs of the flow's couplings and priors on `batch` images:
    the forward pass, or (backward=True) a train step's forward and
    backward (the first coupling of level 0 and the last level's prior see
    inputs that need no gradient)."""
    total = 0
    for li, lv in enumerate(a.levels):
        hw = batch * lv.h * lv.w
        for step in range(a.nflows):
            total += _block(a.couple, lv.a_ch, lv.channel - lv.a_ch, hw,
                            backward, grad_in=li > 0 or step > 0)
        last = li == a.nsplit - 1
        c_in = (lv.z_ch if last else lv.keep_ch) + lv.cond_ch
        total += _block(a.prior, c_in, 2 * lv.z_ch, hw, backward,
                        grad_in=not last)
    return total


def vq_flops(vq: dict, batch: int, size) -> Dict[str, int]:
    """Conv FLOPs of the published VQ-VAE's encoder and decoder on `batch`
    images of `size` (H, W), and of the codebook search's distance product
    (the [N, D] x [D, K] matmul)."""
    hd, C, D, K = (list(vq["hidden_dims"]), vq["channel"], vq["embed_dim"],
                   vq["embed_num"])
    h, w = size
    enc, ch = 0, C
    for d in hd:  # 4x4 stride-2 convs
        h, w = h // 2, w // 2
        enc += 2 * batch * h * w * d * ch * 16
        ch = d
    hw = batch * h * w
    res = lambda n: n * 2 * (2 * hw * ch * ch * 9)  # noqa: E731
    enc += 2 * hw * ch * ch * 9 + 2 * hw * ch * D \
        + res(vq["encoder"]["block_num"])
    dec = 2 * hw * D * ch + 2 * hw * ch * ch * 9 \
        + res(vq["decoder"]["block_num"])
    for d in hd[::-1][1:] + [C]:  # 4x4 stride-2 transposed convs
        dec += 2 * batch * h * w * ch * d * 16
        h, w, ch = h * 2, w * 2, d
    return {"encoder": enc, "decoder": dec, "codebook": 2 * hw * D * K}


def rans_bytes(shapes: Sequence[Tuple[int, int, int]]) -> int:
    """Bytes the three rANS kernels must move to code and decode containers
    of (S, k, words) each."""
    return sum(64 * S * k + 8 * words for S, k, words in shapes)


# -- traces ----------------------------------------------------------------


class Trace:
    """The device and host events of one torch.profiler window."""

    def __init__(self, prof, window_s: float, window_name: str):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            s, t = e.start_ns(), e.end_ns()
            if t <= s:
                continue
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    dev.append((e.name(), s, t))
            else:
                host.append((e.name(), s, t))
        self.window_s = window_s
        self.kernels = dev
        win = [(s, t) for n, s, t in host if n == window_name]
        self.t0 = min(s for s, _ in win) if win else min(
            [s for _, s, _ in dev + host], default=0)
        self.t1 = max(t for _, t in win) if win else max(
            [t for _, _, t in dev + host], default=0)
        self.host = [(n, s, t) for n, s, t in host if n != window_name]
        self.union = self._union()
        self.busy_s = sum(t - s for s, t in self.union) / 1e9

    def _union(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, s, t in sorted(self.kernels, key=lambda k: k[1]):
            s, t = max(s, self.t0), min(t, self.t1)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def kernel_seconds(self, match) -> float:
        """Device seconds of the kernels whose name `match` accepts."""
        return sum(t - s for n, s, t in self.kernels if match(n)) / 1e9

    def top_ops(self, count: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, t in self.kernels:
            by[n] = by.get(n, 0.0) + (t - s) / 1e9
        top = sorted(by.items(), key=lambda kv: -kv[1])[:count]
        return [[n[:160], v] for n, v in top]

    def idle_gaps(self, count: int = 10) -> List[List]:
        """The longest idle gaps of the device in the window, each named by
        what the host was doing: the shortest host event that covers at
        least half of the gap, else the one that covers most of it."""
        edges = [self.t0] + [x for st in self.union for x in st] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:count]
        if not self.host:
            return [["(no host events)", (t - s) / 1e9] for s, t in gaps]
        hs = np.array([s for _, s, _ in self.host], np.int64)
        ht = np.array([t for _, _, t in self.host], np.int64)
        out = []
        for s, t in gaps:
            cover = np.minimum(ht, t) - np.maximum(hs, s)
            best = int(np.argmax(cover))
            half = np.nonzero(cover * 2 >= (t - s))[0]
            if len(half):
                best = int(half[np.argmin((ht - hs)[half])])
            name = self.host[best][0] if cover[best] > 0 else "(host idle)"
            out.append([name[:160], (t - s) / 1e9])
        return out


def median_ms(values: Sequence[float]) -> float:
    return float(np.median(np.asarray(values)) * 1e3)
