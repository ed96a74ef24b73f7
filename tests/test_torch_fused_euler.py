"""Port vs JAX package: the fused force + Euler step. euler_step_fused (K5's
plain path on the CPU) against JAX euler_step_fused in interpret mode at
rtol 1e-5, atol 1e-6 of the scale (the bound tests/test_pallas_force.py:
204-207 holds the fused kernel to); simulate with fused_integrate against
the unfused direct step; the fused + differentiable refusal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu import sim as jsim
from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.ops.pallas_force import euler_step_fused as j_fused
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import BodyState, SimConfig, make_step_fn, simulate
from mini_nbody_tpu_torch.ops import direct_force as df

torch.set_num_threads(1)


def _state(n, seed, masses):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 3)).astype(np.float32) * 0.1
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return pos, vel, m


def _close(got, want, rtol=1e-5, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("n,masses", [(256, False), (300, True), (7, False),
                                      (1, True)])
def test_euler_step_fused_vs_jax(n, masses):
    pos, vel, m = _state(n, n, masses)
    jp, jv = j_fused(jnp.asarray(pos), jnp.asarray(vel),
                     None if m is None else jnp.asarray(m), dt=0.01,
                     softening=1e-2, tile_i=64, tile_j=128, interpret=True)
    before = df.FUSED_LAUNCHES
    tp, tv = df.euler_step_fused(torch.from_numpy(pos), torch.from_numpy(vel),
                                 None if m is None else torch.from_numpy(m),
                                 dt=0.01, softening=1e-2)
    assert df.FUSED_LAUNCHES == before  # the plain version, not the kernel
    _close(tv, jv)
    _close(tp, jp)


def test_fused_plain_is_the_unfused_step_bitwise():
    pos, vel, m = _state(200, 1, True)
    p, v, mm = map(torch.from_numpy, (pos, vel, m))
    fp, fv = df.euler_step_fused(p, v, mm, dt=0.01, softening=1e-2)
    f = df.body_force_direct(p, p, mm, softening=1e-2)
    v2 = v + 0.01 * f
    assert torch.equal(fv, v2) and torch.equal(fp, p + 0.01 * v2)


@pytest.mark.parametrize("use_masses", [False, True])
def test_simulate_fused_vs_unfused_and_jax(use_masses):
    pos, vel, m = _state(128, 2, True)
    jcfg = JSimConfig(n=128, dt=1e-3, steps=5, backend="pallas",
                      softening=1e-2, tile_i=64, tile_j=128,
                      use_masses=use_masses, fused_integrate=True,
                      interpret=True)
    j = jsim.simulate(jcfg, JBodyState.create(pos, vel, m))
    cfg = SimConfig.from_dict(dataclasses.asdict(jcfg))
    assert cfg.fused_integrate and cfg.backend == "direct"
    state = BodyState.from_numpy(pos, vel, m, device="cpu")
    out = simulate(cfg, state)
    ref = simulate(cfg.replace(fused_integrate=False), state)
    assert torch.equal(out.pos, ref.pos) and torch.equal(out.vel, ref.vel)
    assert out.mass is state.mass
    _close(out.pos.numpy(), j.pos, 1e-4, 1e-5)
    _close(out.vel.numpy(), j.vel, 1e-4, 1e-5)


def test_fused_differentiable_refused_like_jax():
    jcfg = JSimConfig(n=64, backend="pallas", fused_integrate=True)
    with pytest.raises(ValueError, match="fused_integrate"):
        jsim.make_step_fn(jcfg, differentiable=True)
    cfg = SimConfig(n=64, backend="direct", fused_integrate=True)
    with pytest.raises(ValueError, match="fused_integrate"):
        make_step_fn(cfg, differentiable=True)


def test_fused_wrapper_checks_inputs():
    p = torch.zeros(16, 3)
    with pytest.raises(TypeError):
        df.euler_step_fused(p, p.double())
    with pytest.raises(ValueError):
        df.euler_step_fused(p, p[:8])
    with pytest.raises(ValueError):
        df.euler_step_fused(p, p, torch.ones(4))
