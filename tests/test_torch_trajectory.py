"""Port vs JAX package: ``trajectory``, ``zeros`` and the batched
``BodyState``.

trajectory on the same numpy state as JAX's trajectory (jnp, pallas, sym and
sym_mxu in interpret mode against the port's torch, direct, sym and sym_mxu
on the CPU, the kernels' plain versions), 6 steps with a snapshot every 2.
Snapshots and final states are held at rtol 1e-4, atol 1e-5 of their scale,
the bound of tests/test_torch_sim.py: both sides are fp32 and differ in
the order of the sums. The port against itself: the last snapshot is
bitwise the final state of simulate. Inputs are np.float32 arrays, since
tests/conftest.py turns on jax_enable_x64."""

import numpy as np
import pytest
import torch

import mini_nbody_tpu as jpkg
import mini_nbody_tpu_torch as pkg
from mini_nbody_tpu import sim as jsim
from mini_nbody_tpu.models import state as jstate
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import BodyState, SimConfig, simulate, trajectory
from mini_nbody_tpu_torch.models import state as tstate

torch.set_num_threads(1)

N, RTOL, ATOL = 200, 1e-4, 1e-5


def _np_state(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            (0.1 * rng.uniform(-1, 1, (n, 3))).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * scale)


@pytest.mark.parametrize("jax_backend,port_backend", [
    ("jnp", "torch"), ("pallas", "direct"), ("sym", "sym"),
    ("sym_mxu", "sym_mxu")])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_trajectory_vs_jax(jax_backend, port_backend, integrator):
    pos, vel, mass = _np_state()
    kw = dict(n=N, dt=1e-3, softening=1e-2, integrator=integrator,
              use_masses=True, sym_tile=64)
    jcfg = JSimConfig(backend=jax_backend, interpret=True, resident=False,
                      **kw)
    jout, jhist = jsim.trajectory(
        jcfg, jstate.BodyState.create(pos, vel, mass), 6, save_every=2)
    out, hist = trajectory(SimConfig(backend=port_backend, **kw),
                           BodyState.from_numpy(pos, vel, mass, device="cpu"),
                           6, save_every=2)
    assert hist.shape == (3, N, 3) == jhist.shape
    _close(hist, jhist)
    _close(out.pos, jout.pos)
    _close(out.vel, jout.vel)


@pytest.mark.parametrize("backend", ["auto", "sym_mxu", "direct"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_last_snapshot_is_simulate(backend, integrator):
    pos, vel, mass = _np_state(seed=1)
    cfg = SimConfig(n=N, dt=1e-3, softening=1e-2, integrator=integrator,
                    use_masses=True, backend=backend)
    state = BodyState.from_numpy(pos, vel, mass, device="cpu")
    out, hist = trajectory(cfg, state, 4, save_every=1)
    ref = simulate(cfg, state, 4)
    assert hist.shape == (4, N, 3)
    assert torch.equal(hist[-1], ref.pos) and torch.equal(out.pos, ref.pos)
    assert torch.equal(out.vel, ref.vel)
    assert torch.equal(hist[1], simulate(cfg, state, 2).pos)


def test_trajectory_validation_and_empty():
    pos, vel, mass = _np_state(seed=2)
    cfg = SimConfig(n=N, softening=1e-2)
    state = BodyState.from_numpy(pos, vel, mass, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        trajectory(cfg, state, 5, save_every=2)
    out, hist = trajectory(cfg, state, 0, save_every=3)
    assert hist.shape == (0, N, 3) and torch.equal(out.pos, state.pos)


def test_entry_points_exported_as_in_jax():
    for name in ("trajectory", "simulate_ensemble", "trajectory_ensemble"):
        assert name in pkg.__all__ and callable(getattr(pkg, name))
        assert callable(getattr(jpkg, name))


@pytest.mark.parametrize("n", [1, 7, 300])
def test_zeros_matches_jax(n):
    want = jstate.zeros(n)
    got = tstate.zeros(n, device="cpu")
    assert got.n == n == want.n
    for g, w in zip(got.to_numpy(), (want.pos, want.vel, want.mass)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
        assert g.dtype == np.float32


def test_batched_state():
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, (4, 50, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (4, 50, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, (4, 50)).astype(np.float32)
    s = BodyState.from_numpy(pos, vel, mass, device="cpu")
    assert s.n == 50 and s.pos.shape == (4, 50, 3) and s.mass.shape == (4, 50)
    for g, w in zip(s.to_numpy(), (pos, vel, mass)):
        np.testing.assert_array_equal(g, w)
    unit = BodyState.create(pos, vel, device="cpu")
    assert torch.equal(unit.mass, torch.ones(4, 50))
    with pytest.raises(ValueError, match="mass"):
        BodyState.create(pos, vel, mass[0], device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        BodyState.create(pos[None], vel[None], device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        BodyState.create(pos, vel[:, :49], device="cpu")
    one = BodyState.create(pos[0], vel[0], mass[0], device="cpu")
    assert one.n == 50 and one.mass.shape == (50,)
