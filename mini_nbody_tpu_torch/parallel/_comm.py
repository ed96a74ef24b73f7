"""The collectives of the sharded path, on ``torch.distributed``.

The counterparts of JAX's ``lax.all_gather(tiled=True)``
(``all_gather_into_tensor``), ``lax.psum_scatter(tiled=True)``
(``reduce_scatter_tensor``) and ``lax.ppermute`` over a ring shift
(``batch_isend_irecv``, started before the hop's compute and waited on
after it). They take contiguous fp32 tensors on the mesh's device, stack
along dim 0 in group rank order, and make no host copy. A group of one rank
still goes through the collective: the process group, not a shortcut,
answers for it.

``CALLS`` counts each collective per call (a ppermute of several tensors is
one call), so a run can show which exchange it made.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

CALLS = {"all_gather": 0, "reduce_scatter": 0, "ppermute": 0}


def _check(x, device):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"collectives take contiguous fp32 tensors, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    if x.device != device:
        raise ValueError(f"tensor on {x.device}, the mesh is on {device}")


def all_gather(x, group, device):
    """x (n, ...) of every rank of group, stacked: (size n, ...)."""
    _check(x, device)
    size = dist.get_world_size(group)
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    CALLS["all_gather"] += 1
    return out


def reduce_scatter(x, group, device):
    """Sum x (size n, ...) over the ranks of group; this rank keeps rows
    [r n, (r + 1) n) of the sum, r its group rank."""
    _check(x, device)
    size = dist.get_world_size(group)
    if x.shape[0] % size != 0:
        raise ValueError(f"{x.shape[0]} rows do not split over {size} ranks")
    out = torch.empty((x.shape[0] // size, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    CALLS["reduce_scatter"] += 1
    return out


def ppermute_start(tensors, shift, group, device):
    """Start the ring shift of ``tensors``: this rank sends each to group
    rank (r + shift) mod P and receives the same shapes from (r - shift) mod
    P. Returns (received buffers, handles); read the buffers only after
    ppermute_wait(handles). A shift that lands on this rank (P = 1, or
    shift a multiple of P) is refused: the exchange has no hop there."""
    size = dist.get_world_size(group)
    if shift % size == 0:
        raise ValueError(f"ring shift {shift} over {size} ranks is no hop")
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % size)
    src = dist.get_global_rank(group, (me - shift) % size)
    ops, bufs = [], []
    for tag, x in enumerate(tensors):
        _check(x, device)
        buf = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, dst, group, tag))
        ops.append(dist.P2POp(dist.irecv, buf, src, group, tag))
        bufs.append(buf)
    CALLS["ppermute"] += 1
    return bufs, dist.batch_isend_irecv(ops)


def ppermute_wait(handles):
    for h in handles:
        h.wait()
