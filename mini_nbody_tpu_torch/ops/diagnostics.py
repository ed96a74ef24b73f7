"""Physics diagnostics: energy, momentum, angular momentum, finiteness.

Counterpart of ``mini_nbody_tpu/ops/diagnostics.py:21-112``: the invariants
a correct force kernel and a symplectic integrator must (nearly) conserve,
and the BASELINE's energy-drift gate (<= 1e-5 over 1000 leapfrog steps).
``total_energy`` takes the potential from ``ops/pe_kernel.py``, which runs
K4 for a CUDA state at every N and its plain version for a CPU state (JAX's
``n >= 65536`` threshold was for its TPU's jnp path and is not carried
over). ``potential_energy`` is the plain reference on any device: K4's
plain version. ``total_energy_ensemble`` and ``momentum_ensemble``
(``:115-136``) take a batched state (``sim.simulate_ensemble``): one
``total_energy`` per system (one K4 launch each on the card), as JAX scans
``total_energy`` over the systems.
"""

from __future__ import annotations

import torch

from mini_nbody_tpu_torch.models.state import BodyState
from mini_nbody_tpu_torch.ops.pe_kernel import (potential_energy_kernel,
                                                potential_energy_plain)
from mini_nbody_tpu_torch.utils.config import SOFTENING


def potential_energy(pos, mass, softening: float = SOFTENING):
    """U = -sum_{i<j} m_i m_j / sqrt(r_ij^2 + eps), whose negative gradient
    is the softened force; the self term is excluded by global index and
    memory stays O(block) (pe_kernel.pe_rows_plain). mass None = unit."""
    return potential_energy_plain(pos, mass, softening)


def kinetic_energy(vel, mass):
    return 0.5 * torch.sum(mass * torch.sum(vel * vel, dim=-1))


def total_energy(state: BodyState, softening: float = SOFTENING):
    """Kinetic + potential, a 0-dim tensor on the state's device."""
    return (kinetic_energy(state.vel, state.mass)
            + potential_energy_kernel(state.pos, state.mass, softening))


def momentum(state: BodyState):
    return torch.sum(state.mass[:, None] * state.vel, dim=0)


def angular_momentum(state: BodyState):
    return torch.sum(state.mass[:, None]
                     * torch.linalg.cross(state.pos, state.vel), dim=0)


def energy_drift(e0, e1):
    """Relative energy drift |E1 - E0| / |E0| (the BASELINE gate: <= 1e-5
    over 1000 steps)."""
    return abs(e1 - e0) / abs(e0)


def check_finite(state: BodyState):
    """NaN / overflow guard: a dict of 0-dim bool tensors."""
    return {
        "pos_finite": torch.isfinite(state.pos).all(),
        "vel_finite": torch.isfinite(state.vel).all(),
        "pos_bounded": (state.pos.abs() < 1e30).all(),
    }


def assert_finite(state: BodyState, context: str = ""):
    """Raise FloatingPointError on a NaN or Inf (syncs with the device)."""
    flags = {k: bool(v) for k, v in check_finite(state).items()}
    if not all(flags.values()):
        raise FloatingPointError(f"non-finite body state {context}: {flags}")


def total_energy_ensemble(state: BodyState, softening: float = SOFTENING):
    """Per-system total energy (B,) of a batched state: pos, vel (B, N, 3),
    mass (B, N)."""
    return torch.stack([
        total_energy(BodyState(pos=p, vel=v, mass=m), softening)
        for p, v, m in zip(state.pos, state.vel, state.mass)])


def momentum_ensemble(state: BodyState):
    """Per-system total momentum (B, 3) of a batched state."""
    return torch.sum(state.vel * state.mass[..., None], dim=1)
