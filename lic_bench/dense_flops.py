"""FLOPs the fused DenseLayer kernel does: the yardstick of a roofline on
the FLOPs actually computed, not the published unfused ones
(`reduce.flow_flops`, 1.87x more on imagenet64).

On the codec's inference path each DenseLayer is one 3x3 convolution of
the block's channel prefix (the 1x1 is composed into its weights), so a
layer of cin input channels and growth g over M = batch x h x w pixels
does 2 M g 9 cin FLOPs.  The count runs over every DenseBlock of one
forward pass of a flow (its couplings and priors, level by level), from
the published widths and the coded geometry; a codec's direction runs
each of them once.  The blocks' 1x1 projections are not counted: they are
matrix products outside the kernel.
"""

from __future__ import annotations

from .reference.flow import Arch, Block, growths


def block_flops(b: Block, c_in: int, m: int) -> int:
    """The kernel's FLOPs for one DenseBlock over m pixels."""
    total, ch = 0, c_in
    for g in growths(b):
        total += 2 * m * g * 9 * ch
        ch += g
    return total


def dense_conv_flops(a: Arch, batch: int) -> int:
    """The kernel's FLOPs for one direction of the flow on `batch`
    images (or tiles) of its (H, W)."""
    total = 0
    for li, lv in enumerate(a.levels):
        m = batch * lv.h * lv.w
        total += a.nflows * block_flops(a.couple, lv.a_ch, m)
        last = li == a.nsplit - 1
        c_in = (lv.z_ch if last else lv.keep_ch) + lv.cond_ch
        total += block_flops(a.prior, c_in, m)
    return total
