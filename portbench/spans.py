"""What the program's own spans say about a traced stretch.

The port opens ``nbody.*`` spans where its work happens
(``mini_nbody_tpu_torch/utils/tracing.annotate``; PERF.md lists them). A
span lands in the same Chrome trace as the device's operations, on the same
clock, as a ``user_annotation`` host event, so ``Trace.host`` holds it.
Each reader returns None where the trace holds no program span at all, as
a program without them gives; the host's spans of all threads are united,
so the autograd thread's backward counts beside the caller's forward.
"""

from __future__ import annotations

import re

PREFIX = "nbody."
#: The spans inside which the host dispatches device work of a force pass.
DISPATCH = ("nbody.force", "nbody.vjp", "nbody.resident")
#: The CUDA runtime's calls that make the host wait for the device.
SYNC = re.compile(r"^cuda\w*Synchronize$")


def _has_spans(trace) -> bool:
    return any(name.startswith(PREFIX) for _, _, name in trace.host)


def _union(intervals, lo, hi):
    """The union of (start, end) intervals clipped to [lo, hi], sorted."""
    merged = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def dispatch_idle(r):
    """Percent of the traced window in which no device operation ran while
    the host was inside a nbody.force, nbody.vjp or nbody.resident span."""
    t = r.trace
    if not _has_spans(t):
        return None
    inside = _union([(a, b) for a, b, name in t.host if name in DISPATCH],
                    t.t0, t.t1)
    return 100.0 * _overlap(t.gaps(), inside) / (t.t1 - t.t0)


def syncs_per_call(r):
    """The CUDA runtime's synchronising calls that start inside a program
    span, per traced call."""
    t = r.trace
    if not _has_spans(t):
        return None
    inside = _union([(a, b) for a, b, name in t.host
                     if name.startswith(PREFIX)], t.t0, t.t1)
    starts = [a for a, _, name in t.host if SYNC.match(name)]
    n = sum(any(lo <= s <= hi for lo, hi in inside) for s in starts)
    return n / r.calls


def force_spans_per_call(r):
    """nbody.force spans that start in the traced window, per call; None
    where there is none."""
    t = r.trace
    n = sum(name == "nbody.force" and t.t0 <= a <= t.t1
            for a, _, name in t.host)
    return n / r.calls if n else None
