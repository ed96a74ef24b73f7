"""mini_nbody_tpu_torch — the PyTorch + CUDA port of mini_nbody_tpu.

Counterpart of ``mini_nbody_tpu/__init__.py:21-43``. The softened all-pairs
gravity step (SOFTENING = 1e-9, self pairs computed and contributing zero,
semi-implicit Euler and leapfrog) with its hot loops as CUDA kernels written
by hand for Hopper (``csrc/``), each beside a plain PyTorch version that CPU
tensors take. Imports torch and numpy only: never jax and never the JAX
package, which stays the reference the port is tested against.
"""

from mini_nbody_tpu_torch.utils.config import SimConfig
from mini_nbody_tpu_torch.models.state import BodyState
from mini_nbody_tpu_torch.models import init
from mini_nbody_tpu_torch.ops.force import body_force, make_force_fn
from mini_nbody_tpu_torch.sim import make_step_fn, simulate

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "BodyState",
    "init",
    "body_force",
    "make_force_fn",
    "make_step_fn",
    "simulate",
]
