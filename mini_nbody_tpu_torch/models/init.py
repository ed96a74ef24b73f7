"""Initial-condition generators.

Counterpart of ``mini_nbody_tpu/models/init.py:19-24`` (``uniform_random``, the
mini-nbody ``randomizeBodies`` distribution). The random streams differ from
``jax.random``, so the two agree in distribution, not bitwise. The other
initializers (plummer, cold_sphere, two_cluster) are not ported yet
(ROADMAP A2).
"""

from __future__ import annotations

import torch

from mini_nbody_tpu_torch.models.state import BodyState


def uniform_random(n: int, generator: torch.Generator | None = None,
                   device=None, dtype=torch.float32) -> BodyState:
    """pos, vel ~ U[-1, 1], drawn on the generator's device and then moved
    to ``device``."""
    gen_device = generator.device if generator is not None else device
    pos = torch.rand((n, 3), generator=generator, device=gen_device,
                     dtype=dtype) * 2.0 - 1.0
    vel = torch.rand((n, 3), generator=generator, device=gen_device,
                     dtype=dtype) * 2.0 - 1.0
    return BodyState.create(pos, vel, dtype=dtype,
                            device=device if device is not None else gen_device)
