"""Process-group start-up for the sharded path.

Counterpart of ``mini_nbody_tpu/parallel/multihost.py:27-65``. JAX's
``jax.distributed.initialize`` reads its coordinator from the environment;
here ``torchrun`` sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK`` and ``initialize`` starts the default process
group from them: NCCL with one card per rank (``cuda:LOCAL_RANK``), gloo
only when the caller asks for the CPU. With none of those variables set it
is a no-op returning False, as JAX's is (single-process mode).

    torchrun --nproc-per-node=<cards> my_run.py   # my_run.py calls
    multihost.initialize(); mesh = multihost.global_mesh()
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def initialize(device: str = "cuda") -> bool:
    """Start the default process group from torchrun's environment if it
    is set: True when distributed mode is active, False (nothing done) when
    none of its variables is set. device "cuda" (the default) takes NCCL on
    cuda:LOCAL_RANK, "cpu" takes gloo; there is no other choice and no
    fallback."""
    if dist.is_initialized():
        return True
    if not any(os.environ.get(k) for k in _ENV):
        return False
    if device == "cpu":
        dist.init_process_group("gloo", init_method="env://")
        return True
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("initialize() runs NCCL on one card per rank and "
                           "found no card; pass device='cpu' for gloo")
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", init_method="env://", device_id=local)
    return True


def global_mesh():
    """1-D body mesh over every rank of the default group."""
    from mini_nbody_tpu_torch.parallel.mesh import make_mesh

    return make_mesh()


def is_primary() -> bool:
    """Rank 0 of the default group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
