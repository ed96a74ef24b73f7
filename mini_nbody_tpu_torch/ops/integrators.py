"""Time integrators.

Counterpart of ``mini_nbody_tpu/ops/integrators.py:26-113``: semi-implicit
Euler (mini-nbody semantics, v then x), leapfrog/KDK, RK4 and the Yoshida
4th-order composition, each ``(state, acc, force_fn, dt) -> (state, acc)``
carrying the acceleration so leapfrog costs one force pass per step.
"""

from __future__ import annotations

from typing import Callable

import torch

from mini_nbody_tpu_torch.models.state import BodyState

ForceFn = Callable[..., torch.Tensor]  # (pos_i, pos_j, mass_j) -> (Ni, 3)


def euler_step(state: BodyState, acc, force_fn: ForceFn, dt: float):
    """Semi-implicit Euler (v then x). `acc` is ignored on input and
    returned as this step's force."""
    f = force_fn(state.pos, state.pos, state.mass)
    vel = state.vel + dt * f
    pos = state.pos + dt * vel
    return BodyState(pos=pos, vel=vel, mass=state.mass), f


def leapfrog_step(state: BodyState, acc, force_fn: ForceFn, dt: float):
    """Kick-drift-kick leapfrog; `acc` must be F(state.pos)."""
    half = 0.5 * dt
    vel_h = state.vel + half * acc
    pos = state.pos + dt * vel_h
    acc_new = force_fn(pos, pos, state.mass)
    vel = vel_h + half * acc_new
    return BodyState(pos=pos, vel=vel, mass=state.mass), acc_new


def rk4_step(state: BodyState, acc, force_fn: ForceFn, dt: float):
    """Classic RK4 on (x, v): four force passes per step. `acc` is ignored
    on input and returned as F(x0)."""

    def a(x):
        return force_fn(x, x, state.mass)

    x0, v0 = state.pos, state.vel
    k1v = a(x0)
    k1x = v0
    k2v = a(x0 + (0.5 * dt) * k1x)
    k2x = v0 + (0.5 * dt) * k1v
    k3v = a(x0 + (0.5 * dt) * k2x)
    k3x = v0 + (0.5 * dt) * k2v
    k4v = a(x0 + dt * k3x)
    k4x = v0 + dt * k3v
    sixth = dt / 6.0
    pos = x0 + sixth * (k1x + 2.0 * k2x + 2.0 * k3x + k4x)
    vel = v0 + sixth * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
    return BodyState(pos=pos, vel=vel, mass=state.mass), k1v


#: Yoshida (1990) coefficients: leapfrog substeps scaled by (w1, w0, w1).
_Y4_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_Y4_W0 = 1.0 - 2.0 * _Y4_W1


def yoshida4_step(state: BodyState, acc, force_fn: ForceFn, dt: float):
    """4th-order symplectic step: three leapfrog substeps; `acc` carries
    as in leapfrog_step."""
    s, a = state, acc
    for w in (_Y4_W1, _Y4_W0, _Y4_W1):
        s, a = leapfrog_step(s, a, force_fn, w * dt)
    return s, a


INTEGRATORS = {"euler": euler_step, "leapfrog": leapfrog_step,
               "rk4": rk4_step, "yoshida4": yoshida4_step}

#: Force passes per step.
FORCE_EVALS = {"euler": 1, "leapfrog": 1, "rk4": 4, "yoshida4": 3}

#: Integrators whose acc carry is the previous step's final force.
CARRIES_ACC = ("leapfrog", "yoshida4")


def initial_acc(state: BodyState, force_fn: ForceFn, integrator: str):
    """Acceleration carry needed before the first step."""
    if integrator in CARRIES_ACC:
        return force_fn(state.pos, state.pos, state.mass)
    return torch.zeros_like(state.pos)
