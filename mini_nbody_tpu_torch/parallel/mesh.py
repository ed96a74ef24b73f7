"""The device mesh of the sharded path, over ``torch.distributed``.

Counterpart of ``mini_nbody_tpu/parallel/mesh.py:22-53``. JAX's ``Mesh`` is
one program's view of every device; here each process is one rank of a
process group and holds one device, so ``Mesh`` is this rank's view: the
mesh shape, its coordinates, its device and one process sub-group per mesh
axis. A 1-D mesh ``(P,)`` shards bodies over "i"; a 2-D mesh ``(Pi, Pj)`` is
the pair-matrix grid: rank r = a Pj + b (JAX's i-major ``P(("i", "j"))``
layout) sits at (a, b) and owns body block r. The "j" axis group of (a, b)
is its row group, the ranks that share a; the "i" axis group is its column
group, the ranks that share b. On a 1-D mesh the "i" group is the whole
mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

BODY_AXIS = "i"
COL_AXIS = "j"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D or 2-D mesh.

    shape: (P,) or (Pi, Pj); coords: this rank's (a,) or (a, b); index: its
    rank in the mesh, a Pj + b, which is also its body block; device: the
    device its tensors live on; group: every rank of the mesh; axis_groups:
    the sub-group of each axis name that holds this rank."""

    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    index: int
    device: torch.device
    group: dist.ProcessGroup
    axis_groups: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (BODY_AXIS,) if len(self.shape) == 1 else (BODY_AXIS,
                                                          COL_AXIS)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (JAX lax.axis_index)."""
        return self.coords[self.axis_names.index(axis)]


def make_mesh(shape: Union[int, Tuple[int, ...], None] = None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh over ``group`` (the default process group when None), in
    group rank order: an int or 1-tuple for a 1-D mesh, (Pi, Pj) for the
    2-D grid, None for a 1-D mesh over every rank. Its device is the
    current CUDA device under NCCL (one card per rank) and the CPU under
    gloo. Sub-group creation is collective over the default group, so
    every process of it calls make_mesh with the same arguments, in the
    same order as its other group creations."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(multihost.initialize or "
                           "torch.distributed.init_process_group)")
    group = dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group)
    if shape is None:
        shape = (len(ranks),)
    elif isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"mesh must be 1-D or 2-D, got shape {shape}")
    if math.prod(shape) != len(ranks):
        raise ValueError(f"mesh shape {shape} != {len(ranks)} ranks")
    index = dist.get_rank(group)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    if len(shape) == 1:
        return Mesh(shape, (index,), index, device, group,
                    {BODY_AXIS: group})
    pi, pj = shape
    a, b = divmod(index, pj)
    rows, _ = dist.new_subgroups_by_enumeration(
        [[ranks[x * pj + y] for y in range(pj)] for x in range(pi)])
    cols, _ = dist.new_subgroups_by_enumeration(
        [[ranks[x * pj + y] for x in range(pi)] for y in range(pj)])
    return Mesh(shape, (a, b), index, device, group,
                {BODY_AXIS: cols, COL_AXIS: rows})
