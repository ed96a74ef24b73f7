"""The benchmark's inputs, made on the device from the seed.

Both the program and the reference get these tensors; the program never
makes its own. Each draw is one or a few large calls on a ``torch.Generator``
of the device, in float32, the type the port serves.

* ``uniform_bodies``: mini-nbody's ``randomizeBodies`` (harrism/mini-nbody
  ``nbody.c``): every coordinate of position and velocity uniform in
  [-1, 1], unit masses.
* ``plummer_bodies``: a Plummer sphere (Aarseth, Henon & Wielen 1974) in
  N-body units (G = M = 1, virial radius 1), masses 1 / n, in its centre of
  mass frame: radii from the inverse of the cumulative mass profile, speeds
  by rejection from q^2 (1 - q^2)^(7/2) of the local escape speed.
"""

from __future__ import annotations

import math

import torch

#: Rejection rounds a body of the Plummer sampler draws at once; a body
#: accepts in a round with probability ~0.49, so all 32 fail with
#: probability ~2^-32, and such a body takes the last draw.
PLUMMER_ROUNDS = 32


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A device generator for ``seed`` (any whole number) and a stream
    index, so that inputs and samples draw from separate streams."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def uniform_bodies(shape_n, gen: torch.Generator):
    """(pos, vel, mass) of mini-nbody's randomizeBodies: shape_n is n or
    (systems, n); pos and vel (..., 3) uniform in [-1, 1], mass ones."""
    lead = (shape_n,) if isinstance(shape_n, int) else tuple(shape_n)
    u = torch.rand((*lead, 6), generator=gen, device=gen.device)
    u.mul_(2.0).sub_(1.0)
    pos = u[..., :3].contiguous()
    vel = u[..., 3:].contiguous()
    return pos, vel, torch.ones(lead, device=gen.device)


def _directions(u, v):
    """Unit vectors from two uniform draws in [0, 1): z uniform in
    [-1, 1] and the azimuth uniform."""
    z = 2.0 * u - 1.0
    phi = 2.0 * math.pi * v
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)


def plummer_bodies(n: int, gen: torch.Generator):
    """(pos, vel, mass) of an n-body Plummer sphere, masses 1 / n."""
    dev = gen.device
    u = torch.rand((n, 5), generator=gen, device=dev)
    # Cumulative mass fraction in (1e-6, 1 - 1e-4): r stays finite (below
    # ~122 in Plummer units, clamped at 100).
    frac = 1e-6 + u[:, 0] * (1.0 - 1e-4 - 1e-6)
    r = torch.clamp((frac ** (-2.0 / 3.0) - 1.0) ** -0.5, max=100.0)
    pos = r[:, None] * _directions(u[:, 1], u[:, 2])
    q = torch.rand((n, PLUMMER_ROUNDS, 2), generator=gen, device=dev)
    cand, height = q[..., 0], 0.1 * q[..., 1]
    ok = height < cand * cand * (1.0 - cand * cand) ** 3.5
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    speed_frac = torch.gather(cand, 1, first[:, None])[:, 0]
    v_esc = math.sqrt(2.0) * (1.0 + r * r) ** -0.25
    vel = (speed_frac * v_esc)[:, None] * _directions(u[:, 3], u[:, 4])
    # Plummer units to N-body units: lengths x 3 pi / 16, speeds / sqrt.
    scale = 3.0 * math.pi / 16.0
    pos = pos * scale
    vel = vel / math.sqrt(scale)
    pos = pos - pos.mean(dim=0, keepdim=True)
    vel = vel - vel.mean(dim=0, keepdim=True)
    return (pos.contiguous(), vel.contiguous(),
            torch.full((n,), 1.0 / n, device=dev))


INITS = {"uniform": uniform_bodies, "plummer": plummer_bodies}


def make(init: str, shape_n, seed: int, device):
    """(pos, vel, mass) float32 of the named distribution; shape_n is n or
    (systems, n) (uniform only)."""
    return INITS[init](shape_n, generator(seed, device))


def sample_rows(n: int, k: int, seed: int, device) -> torch.Tensor:
    """k distinct body indices out of n, drawn from the seed, sorted."""
    g = generator(seed, device, stream=1)
    if k >= n:
        return torch.arange(n, device=device)
    return torch.randperm(n, generator=g, device=device)[:k].sort().values
