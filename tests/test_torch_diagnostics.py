"""Port vs JAX package: the diagnostics and the initializers.

potential_energy (the plain reference) and potential_energy_kernel
(K4's plain path on the CPU) against JAX potential_energy and
potential_energy_pallas in interpret mode, at |dU| <= 1e-5 |U|: fp32 sums of
the same terms in another order. Kinetic energy, momentum, angular momentum,
energy_drift and check_finite against JAX. plummer, cold_sphere and
two_cluster by distribution, since torch.Generator and jax.random give
different streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.models import init as jinit
from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.ops import diagnostics as jdg
from mini_nbody_tpu.ops.pe_kernel import potential_energy_pallas
from mini_nbody_tpu_torch import BodyState, init
from mini_nbody_tpu_torch.ops import diagnostics as dg
from mini_nbody_tpu_torch.ops import pe_kernel as pk
from mini_nbody_tpu_torch.utils import tracing

torch.set_num_threads(1)

U_RTOL = 1e-5


def _state(n, seed, masses=True, coincident=False):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    m = (rng.uniform(0.5, 2.0, n) if masses else np.ones(n)).astype(
        np.float32)
    if coincident:
        pos[20] = pos[10]  # two distinct bodies at one point
    return pos, vel, m


def _both(pos, vel, m):
    return (JBodyState.create(pos, vel, m),
            BodyState.from_numpy(pos, vel, m, device="cpu"))


def _u_close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= U_RTOL * abs(want), (got, want)


def _u_oracle(pos, m, softening):
    p = pos.astype(np.float64)
    d = p[None] - p[:, None]
    inv = 1.0 / np.sqrt((d * d).sum(-1) + softening)
    mm = m.astype(np.float64)[:, None] * m.astype(np.float64)[None, :]
    return -0.5 * (mm * inv)[~np.eye(len(p), dtype=bool)].sum()


@pytest.mark.parametrize("n,masses,softening", [
    (300, True, 1e-2), (300, False, 1e-2), (257, True, 1e-9),
    (64, True, 1e-6)])
def test_potential_energy_vs_jax(n, masses, softening):
    pos, _, m = _state(n, n, masses, coincident=n == 64)
    want = jdg.potential_energy(jnp.asarray(pos), jnp.asarray(m), softening)
    got = dg.potential_energy(torch.from_numpy(pos), torch.from_numpy(m),
                              softening)
    assert got.dtype == torch.float32
    _u_close(got, want)
    _u_close(got, _u_oracle(pos, m, softening))


@pytest.mark.parametrize("n,masses,softening", [
    (256, True, 1e-2), (300, False, 1e-2), (300, True, 1e-9),
    (64, True, 1e-6), (64, False, 1e-6)])
def test_potential_energy_kernel_plain_vs_jax_pallas(n, masses, softening):
    # Ragged unit-mass N exercises JAX's synthesized zero-padded masses;
    # N = 64 holds two distinct coincident bodies whose eps^-1/2 term (1000
    # at eps 1e-6, ~40% of |U|) must stay: the diagonal is masked by index.
    pos, _, m = _state(n, n + 1, masses, coincident=n == 64)
    jm, tm = ((jnp.asarray(m), torch.from_numpy(m)) if masses
              else (None, None))
    want = potential_energy_pallas(jnp.asarray(pos), jm, softening=softening,
                                   tile_i=64, tile_j=128, interpret=True)
    before = tracing.counters()
    got = pk.potential_energy_kernel(torch.from_numpy(pos), tm, softening)
    # the plain version: no kernel launched
    moved = tracing.counters() - before
    assert not [k for k in moved if k.startswith("launch.")]
    _u_close(got, want)
    _u_close(got, _u_oracle(pos, m, softening))


def test_coincident_bodies_keep_their_term():
    pos, _, m = _state(64, 3, coincident=True)
    u = float(pk.potential_energy_kernel(torch.from_numpy(pos),
                                         torch.from_numpy(m), 1e-6))
    d = pos[None] - pos[:, None]
    coincident = ((d * d).sum(-1) == 0) & ~np.eye(64, dtype=bool)
    term = -0.5 * float((np.outer(m, m) / np.sqrt(1e-6))[coincident].sum())
    assert abs(term) > 0.1 * abs(u)
    _u_close(u, _u_oracle(pos, m, 1e-6))


def test_kernel_wrapper_checks_inputs():
    p = torch.zeros(16, 3)
    with pytest.raises(TypeError):
        pk.potential_energy_kernel(p.double())
    with pytest.raises(ValueError):
        pk.potential_energy_kernel(p, torch.ones(8))
    with pytest.raises(ValueError):
        pk.potential_energy_kernel(p.t().contiguous().t())


@pytest.mark.parametrize("masses", [False, True])
def test_total_energy_and_invariants_vs_jax(masses):
    j, t = _both(*_state(200, 5, masses))
    _u_close(dg.total_energy(t, 1e-2), jdg.total_energy(j, 1e-2))
    _u_close(dg.kinetic_energy(t.vel, t.mass),
             jdg.kinetic_energy(j.vel, j.mass))
    np.testing.assert_allclose(dg.momentum(t).numpy(),
                               np.asarray(jdg.momentum(j)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dg.angular_momentum(t).numpy(),
                               np.asarray(jdg.angular_momentum(j)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("e0,e1", [(-1.0, -1.0), (-0.25, -0.2500025),
                                   (3.0, 2.5)])
def test_energy_drift_vs_jax(e0, e1):
    want = float(jdg.energy_drift(jnp.float32(e0), jnp.float32(e1)))
    got = dg.energy_drift(torch.tensor(e0), torch.tensor(e1)).item()
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    # Python floats stay float64 on both sides (x64 is on in these tests).
    assert dg.energy_drift(e0, e1) == pytest.approx(
        float(jdg.energy_drift(e0, e1)), rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("bad", [None, "nan_pos", "inf_vel", "huge_pos"])
def test_check_finite_vs_jax(bad):
    pos, vel, m = _state(16, 6)
    if bad == "nan_pos":
        pos[3, 1] = np.nan
    elif bad == "inf_vel":
        vel[5, 0] = np.inf
    elif bad == "huge_pos":
        pos[7, 2] = 1e31
    j, t = _both(pos, vel, m)
    want = {k: bool(v) for k, v in jdg.check_finite(j).items()}
    got = {k: bool(v) for k, v in dg.check_finite(t).items()}
    assert got == want
    if bad is None:
        dg.assert_finite(t)
    else:
        with pytest.raises(FloatingPointError):
            dg.assert_finite(t, "in a test")


#: 2K/|U| of a 512-body Plummer sample: its spread over 8 seeds was 0.03
#: (JAX) and 0.05 (port), so two samples agree within 0.25 (> 4 sigma).
VIRIAL_TOL = 0.25
N_INIT = 512


def test_plummer_by_distribution():
    j = jinit.plummer(jax.random.key(2), N_INIT)
    t = init.plummer(N_INIT, generator=torch.Generator().manual_seed(2),
                     device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.float32
    assert float(t.mass.sum()) == pytest.approx(1.0, rel=1e-6)
    assert torch.all(t.mass == t.mass[0])
    for arr in (t.pos, t.vel):  # centre-of-mass frame, at rest
        assert float((t.mass[:, None] * arr).sum(0).abs().max()) < 1e-6
    # the radius cap: r <= 100 before the 16/(3 pi) rescale
    assert float(t.pos.norm(dim=1).max()) <= 100 * 3 * np.pi / 16 + 1e-3
    vj = 2 * float(jdg.kinetic_energy(j.vel, j.mass)) / -float(
        jdg.potential_energy(j.pos, j.mass, 1e-9))
    vt = 2 * float(dg.kinetic_energy(t.vel, t.mass)) / -float(
        dg.potential_energy(t.pos, t.mass, 1e-9))
    assert abs(vt - vj) < VIRIAL_TOL
    assert abs(vt - 1.0) < VIRIAL_TOL


def test_cold_sphere_by_distribution():
    j = jinit.cold_sphere(jax.random.key(3), N_INIT)
    t = init.cold_sphere(N_INIT, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    r = t.pos.norm(dim=1)
    assert float(r.max()) <= 1.0 + 1e-6
    assert torch.equal(t.vel, torch.zeros_like(t.vel))
    assert torch.all(t.mass == 1.0 / N_INIT)
    # uniform in the ball: E[r] = 3/4, sampling std ~0.19 / sqrt(512)
    rj = np.linalg.norm(np.asarray(j.pos), axis=1)
    assert abs(float(r.mean()) - 0.75) < 0.04
    assert abs(float(r.mean()) - rj.mean()) < 0.05


def test_two_cluster_by_distribution():
    j = jinit.two_cluster(jax.random.key(4), N_INIT)
    t = init.two_cluster(N_INIT, generator=torch.Generator().manual_seed(4),
                         device="cpu")
    h = N_INIT // 2
    assert float(t.mass.sum()) == pytest.approx(1.0, rel=1e-6)
    for a, sign in ((slice(0, h), -1.0), (slice(h, None), 1.0)):
        com = t.pos[a].mean(0).numpy()
        jcom = np.asarray(j.pos[a]).mean(0)
        np.testing.assert_allclose(com, [2.0 * sign, 0, 0], atol=1e-5)
        np.testing.assert_allclose(com, jcom, atol=1e-5)
        np.testing.assert_allclose(t.vel[a].mean(0).numpy(),
                                   [-0.15 * sign, 0, 0], atol=1e-5)


def test_presets_and_make_like_jax():
    assert set(init.PRESETS) == set(jinit.PRESETS)
    gen = torch.Generator().manual_seed(5)
    s = init.make("plummer", 64, generator=gen, device="cpu")
    again = init.make("plummer", 64,
                      generator=torch.Generator().manual_seed(5),
                      device="cpu")
    assert s.n == 64 and torch.equal(s.pos, again.pos)
    for name in init.PRESETS:
        assert init.make(name, 32, device="cpu").n == 32
    with pytest.raises(ValueError):
        jinit.make("galaxy", jax.random.key(0), 8)
    with pytest.raises(ValueError):
        init.make("galaxy", 8, device="cpu")
