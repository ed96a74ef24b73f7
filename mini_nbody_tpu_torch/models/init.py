"""Initial-condition generators.

Counterpart of ``mini_nbody_tpu/models/init.py:19-126``: ``uniform_random``
(the mini-nbody ``randomizeBodies`` distribution), ``plummer``,
``cold_sphere``, ``two_cluster``, ``PRESETS`` and ``make``, with the same
algorithms. Numbers are drawn from an explicit ``torch.Generator`` (on its
own device) or, without one, from the default generator of ``device``; the
state lands on ``device``, the card unless the caller names another. The
random streams differ from ``jax.random``, so the two packages agree in
distribution, not bitwise.
"""

from __future__ import annotations

import math

import torch

from mini_nbody_tpu_torch.models.state import BodyState


class _Draw:
    """Uniform and normal draws from one generator (or device default)."""

    def __init__(self, generator, device):
        self.gen = generator
        self.device = generator.device if generator is not None else device

    def uniform(self, shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return u * (hi - lo) + lo

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)


def uniform_random(n: int, generator: torch.Generator | None = None,
                   device="cuda", dtype=torch.float32) -> BodyState:
    """pos, vel ~ U[-1, 1], unit masses."""
    draw = _Draw(generator, device)
    pos = draw.uniform((n, 3), -1.0, 1.0)
    vel = draw.uniform((n, 3), -1.0, 1.0)
    return BodyState.create(pos, vel, dtype=dtype, device=device)


def _isotropic(draw, radius):
    z = draw.uniform(radius.shape, -1.0, 1.0)
    phi = draw.uniform(radius.shape, 0.0, 2.0 * math.pi)
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return radius[:, None] * torch.stack(
        [s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)


def _plummer(draw, n, total_mass):
    """Plummer sphere (pos, vel, mass) in fp32 on draw's device."""
    m = torch.full((n,), total_mass / n, device=draw.device)
    # Inverse CDF of the cumulative mass profile, cut at r ~ 122 and clamped
    # at 100 (the JAX bounds: u^(-2/3) - 1 must not round to 0 in fp32).
    u = draw.uniform((n,), 1e-6, 1.0 - 1e-4)
    r = torch.clamp((u ** (-2.0 / 3.0) - 1.0) ** -0.5, max=100.0)
    pos = _isotropic(draw, r)
    # Speed fraction q with density q^2 (1 - q^2)^(7/2): 32 rejection rounds
    # per body, the first accepted one, else 0.4.
    q = draw.uniform((n, 32))
    g = draw.uniform((n, 32), 0.0, 0.1)
    ok = g < q * q * (1.0 - q * q) ** 3.5
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    picked = torch.gather(q, 1, first[:, None])[:, 0]
    q = torch.where(ok.any(dim=1), picked, torch.full_like(picked, 0.4))
    v_esc = math.sqrt(2.0) * (1.0 + r * r) ** -0.25
    vel = _isotropic(draw, q * v_esc)
    # Standard units G = M = 1: the 16 / (3 pi) virial-radius scale.
    scale = 16.0 / (3.0 * math.pi)
    pos = pos / scale
    vel = vel * math.sqrt(scale)
    return (pos - pos.mean(dim=0, keepdim=True),
            vel - vel.mean(dim=0, keepdim=True), m)


def plummer(n: int, generator: torch.Generator | None = None, device="cuda",
            dtype=torch.float32, total_mass: float = 1.0) -> BodyState:
    """Plummer-sphere equilibrium model (Aarseth, Henon & Wielen 1974), in
    its centre-of-mass frame, masses total_mass / n."""
    pos, vel, m = _plummer(_Draw(generator, device), n, total_mass)
    return BodyState.create(pos, vel, m, dtype=dtype, device=device)


def cold_sphere(n: int, generator: torch.Generator | None = None,
                device="cuda", dtype=torch.float32) -> BodyState:
    """Cold uniform unit ball (zero velocities), masses 1 / n."""
    draw = _Draw(generator, device)
    g = draw.normal((n, 3))
    g = g / torch.linalg.norm(g, dim=1, keepdim=True)
    pos = g * draw.uniform((n, 1)) ** (1.0 / 3.0)
    return BodyState.create(pos, torch.zeros_like(pos),
                            torch.full((n,), 1.0 / n), dtype=dtype,
                            device=device)


def two_cluster(n: int, generator: torch.Generator | None = None,
                device="cuda", dtype=torch.float32, separation: float = 4.0,
                approach: float = 0.3) -> BodyState:
    """Two Plummer spheres of mass 1/2 on a collision course."""
    draw = _Draw(generator, device)
    n1 = n // 2
    pa, va, ma = _plummer(draw, n1, 0.5)
    pb, vb, mb = _plummer(draw, n - n1, 0.5)
    off = torch.tensor([separation / 2, 0.0, 0.0], device=draw.device)
    kick = torch.tensor([approach / 2, 0.0, 0.0], device=draw.device)
    return BodyState.create(torch.cat([pa - off, pb + off]),
                            torch.cat([va + kick, vb - kick]),
                            torch.cat([ma, mb]), dtype=dtype, device=device)


PRESETS = {
    "uniform": uniform_random,
    "plummer": plummer,
    "cold_sphere": cold_sphere,
    "two_cluster": two_cluster,
}


def make(name: str, n: int, generator: torch.Generator | None = None,
         device="cuda", dtype=torch.float32) -> BodyState:
    if name not in PRESETS:
        raise ValueError(
            f"unknown preset {name!r}; options: {sorted(PRESETS)}")
    return PRESETS[name](n, generator=generator, device=device, dtype=dtype)
