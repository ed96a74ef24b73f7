"""Body state: SoA tensors on one device.

Counterpart of ``mini_nbody_tpu/models/state.py:23-90``: ``(N, 3)`` positions
and velocities and ``(N,)`` masses, fp32, on the card unless the caller
names another device (``device="cpu"``; without a card the default raises).
Masses double as the tail-padding mask (mass 0 bodies exert no force). An
ensemble state (``sim.simulate_ensemble``) is batched: pos and vel
``(B, N, 3)``, mass ``(B, N)``; ``n`` is the per-system N.
``from_numpy`` and
``to_numpy`` carry a state across from the JAX package, whose state is the
system's only "parameters".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mini_nbody_tpu_torch.utils.config import FAR


@dataclasses.dataclass
class BodyState:
    """pos (N, 3), vel (N, 3), mass (N,) tensors on one device, or a batch
    of B systems: (B, N, 3), (B, N, 3), (B, N)."""

    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor

    @property
    def n(self) -> int:
        """Bodies per system."""
        return self.pos.shape[-2]

    @property
    def dtype(self):
        return self.pos.dtype

    @property
    def device(self):
        return self.pos.device

    @staticmethod
    def create(pos, vel, mass=None, dtype=torch.float32,
               device="cuda") -> "BodyState":
        pos = torch.as_tensor(pos, dtype=dtype, device=device)
        vel = torch.as_tensor(vel, dtype=dtype, device=pos.device)
        if mass is None:
            mass = torch.ones(pos.shape[:-1], dtype=dtype, device=pos.device)
        else:
            mass = torch.as_tensor(mass, dtype=dtype, device=pos.device)
        if (pos.shape != vel.shape or pos.ndim not in (2, 3)
                or pos.shape[-1] != 3):
            raise ValueError(f"bad shapes pos={tuple(pos.shape)} "
                             f"vel={tuple(vel.shape)}")
        if mass.shape != pos.shape[:-1]:
            raise ValueError(f"bad mass shape {tuple(mass.shape)} for "
                             f"pos {tuple(pos.shape)}")
        return BodyState(pos=pos.contiguous(), vel=vel.contiguous(),
                         mass=mass.contiguous())

    @staticmethod
    def from_numpy(pos, vel, mass=None, device="cuda") -> "BodyState":
        """State from numpy arrays (e.g. ``np.asarray`` of a JAX state),
        copied, so the tensors never alias a read-only buffer."""
        return BodyState.create(
            np.array(pos, np.float32), np.array(vel, np.float32),
            None if mass is None else np.array(mass, np.float32),
            device=device)

    def to_numpy(self):
        """(pos, vel, mass) as numpy arrays on the host."""
        return tuple(t.detach().cpu().numpy()
                     for t in (self.pos, self.vel, self.mass))

    def pad_to(self, n_pad: int, far: bool = False) -> "BodyState":
        """Pad to n_pad bodies with mass 0 (inert under mass-weighted
        kernels); with far=True they also sit at FAR so the unit-mass
        kernels leave them inert (w underflows to 0)."""
        n = self.n
        if n_pad < n:
            raise ValueError(f"cannot pad {n} bodies down to {n_pad}")
        if n_pad == n:
            return self
        extra = n_pad - n
        kw = dict(dtype=self.dtype, device=self.device)
        return BodyState(
            pos=torch.cat([self.pos, torch.full((extra, 3),
                                                FAR if far else 0.0, **kw)]),
            vel=torch.cat([self.vel, torch.zeros((extra, 3), **kw)]),
            mass=torch.cat([self.mass, torch.zeros((extra,), **kw)]),
        )

    def unpad(self, n: int) -> "BodyState":
        return BodyState(pos=self.pos[:n], vel=self.vel[:n],
                         mass=self.mass[:n])


def zeros(n: int, dtype=torch.float32, device="cuda") -> BodyState:
    """n bodies at the origin, at rest, with unit masses."""
    return BodyState(pos=torch.zeros((n, 3), dtype=dtype, device=device),
                     vel=torch.zeros((n, 3), dtype=dtype, device=device),
                     mass=torch.ones((n,), dtype=dtype, device=device))
