"""The program's own spans in a traced run.

The package opens a program span (`utils.profiling.span`) at each host
boundary of its hot paths; while the profiler records, a span is a
`record_function` range, a host event of the same trace as the device's
kernels and on the same clock.  A reader here takes the host events of
the named spans inside the traced window (`harness.WINDOW_SPAN`), clipped
to it, and gives the host milliseconds they cover per traced pass: the
union of their intervals, so a span nested in another of the names counts
once, less, for a self time, the part that spans of the names in `less`
cover.  A run whose window holds none of the names reads None (the
program under test opens no such span), not 0.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def intervals(r, names: Iterable[str]) -> List[Tuple[int, int]]:
    """[(start ns, end ns)] of the host events named in `names` that lie
    in the traced window, clipped to it."""
    tr, names = r.trace, set(names)
    out = []
    for n, s, t in tr.host:
        s, t = max(s, tr.t0), min(t, tr.t1)
        if n in names and t > s:
            out.append((s, t))
    return out


def union(ivs: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The intervals merged where they overlap, in order."""
    out: List[List[int]] = []
    for s, t in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def overlap_ns(a, b) -> int:
    """Nanoseconds that two merged interval lists cover both."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_ms(r, names: Iterable[str],
            less: Iterable[str] = ()) -> Optional[float]:
    """Host milliseconds per traced pass that the spans `names` cover in
    the traced window, less the part the spans `less` cover; None where
    the window holds none of `names`."""
    own = union(intervals(r, names))
    if not own or r.passes <= 0:
        return None
    ns = sum(t - s for s, t in own)
    if less:
        ns -= overlap_ns(own, union(intervals(r, less)))
    return ns / 1e6 / r.passes
