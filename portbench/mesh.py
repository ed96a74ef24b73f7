"""What the mesh cell's per-layer metrics read beyond one card's trace.

The benchmark traces rank 0 alone, so a share of the problem's work is
this card's: the problem's work (``work.problem``) over the ranks of the
group that rank 0's process belongs to while the metrics are read (before
the traffic Driver's ``release``), one where there is no group.

The exchange runs on NCCL's stream while the host has moved on: a
collective's ``nbody.comm`` span holds only its enqueue. So the exchange
the step does not hide is read on the device: the time in which a
collective's kernel runs and no other device operation does, and beside it
the idle time in which the host is inside a ``nbody.comm`` span.
"""

from __future__ import annotations

import re

from portbench import profiling, spans

COMM_SPAN = "nbody.comm"


def ranks() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def card_share(r, work_key: str) -> float:
    """Seconds: this card's share of the calls' ``work_key`` work at the
    card's bound."""
    return r.problem[work_key].bound_s() * r.calls / ranks()


def exposed_comm(r):
    """Percent of the traced window in which a collective's kernel
    (layers/collectives.json) runs and no other device operation does, or
    the device is idle while the host is inside a nbody.comm span; None
    where the trace holds no nbody.comm span."""
    t = r.trace
    comm = [(a, b) for a, b, name in t.host if name == COMM_SPAN]
    if not comm:
        return None
    pattern = re.compile(
        "|".join(profiling.layer_patterns("collectives")))
    coll = spans._union([(a, b) for name, a, b in t.ops
                         if pattern.search(name)], t.t0, t.t1)
    other = spans._union([(a, b) for name, a, b in t.ops
                          if not pattern.search(name)], t.t0, t.t1)
    alone = sum(b - a for a, b in coll) - spans._overlap(coll, other)
    waiting = spans._overlap(t.gaps(), spans._union(comm, t.t0, t.t1))
    return 100.0 * (alone + waiting) / (t.t1 - t.t0)
