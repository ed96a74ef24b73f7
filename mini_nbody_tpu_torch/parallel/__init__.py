"""The sharded path on ``torch.distributed`` (counterpart of
``mini_nbody_tpu/parallel/__init__.py``)."""

from mini_nbody_tpu_torch.parallel.mesh import make_mesh
from mini_nbody_tpu_torch.parallel.sharded import (
    make_sharded_step_fn,
    shard_state,
    simulate_sharded,
    trajectory_sharded,
)

__all__ = ["make_mesh", "make_sharded_step_fn", "shard_state",
           "simulate_sharded", "trajectory_sharded"]
