"""The benchmark's reference and inputs against the port's plain CPU path at
small N. The reference itself imports nothing of the port
(test_portbench_imports.py); only this test brings the two together."""

import pytest
import torch

from portbench import inputs
from portbench.reference import force as rf
from portbench.reference import integrate as ri

PHYSICS = {"uniform": 1e-9, "plummer": 1e-2}


def bodies(init, n=256, seed=7):
    pos, vel, mass = inputs.make(init, n, seed, "cpu")
    return pos.double(), vel.double(), mass.double()


@pytest.mark.parametrize("init", sorted(PHYSICS))
def test_accel_matches_the_ports_plain_force(init):
    from mini_nbody_tpu_torch.ops.reference import body_force_torch

    x, _, m = bodies(init)
    eps = PHYSICS[init]
    want = body_force_torch(x, x, m, softening=eps)
    scale = want.norm(dim=1).median()
    assert ((rf.accel(x, m, eps) - want).norm(dim=1).max() / scale
            < 1e-10)
    assert ((rf.accel_plain(x, x, m, eps) - want).norm(dim=1).max() / scale
            < 1e-12)
    rows = torch.tensor([0, 5, 17, 255])
    assert torch.allclose(rf.accel(x, m, eps, rows=rows), want[rows],
                          rtol=0, atol=1e-10 * float(scale))


@pytest.mark.parametrize("init", sorted(PHYSICS))
def test_accel_vjp_matches_the_ports_plain_vjp(init):
    # the port's chunked PyTorch VJP (its backend="torch" backward), which
    # zeroes the self pair's w and u as the reference does; autograd
    # through the plain force would cancel w = eps^-1.5 ~ 3e13 at eps 1e-9
    from mini_nbody_tpu_torch.ops.autodiff import _vjp_pos

    x, _, m = bodies(init, n=128)
    eps = PHYSICS[init]
    g = torch.randn(x.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    want = _vjp_pos(x, g, m, eps)
    got = rf.accel_vjp(x, m, g, eps)
    assert (got - want).abs().max() / want.abs().max() < 1e-10


@pytest.mark.parametrize("init", sorted(PHYSICS))
def test_potential_matches_the_ports_plain_potential(init):
    from mini_nbody_tpu_torch.ops.diagnostics import potential_energy

    x, v, m = bodies(init)
    eps = PHYSICS[init]
    want = float(potential_energy(x, m, eps))
    assert float(rf.potential(x, m, eps)) == pytest.approx(want, rel=1e-12)
    assert float(rf.potential_plain(x, m, eps)) == pytest.approx(want,
                                                                 rel=1e-12)
    assert float(rf.kinetic(v, m)) == pytest.approx(
        float(0.5 * (m * (v * v).sum(1)).sum()), rel=1e-14)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_updates_match_the_ports_step_loop(integrator):
    from mini_nbody_tpu_torch import BodyState, SimConfig, sim

    init = "uniform" if integrator == "euler" else "plummer"
    x, v, m = bodies(init, n=200)
    eps, dt = PHYSICS[init], 1e-3
    cfg = SimConfig(n=200, dt=dt, softening=eps, integrator=integrator,
                    backend="torch", use_masses=True)
    out = sim.simulate(cfg, BodyState(x, v, m), steps=5)
    pairs = ri.Pairs(torch.float64)
    if integrator == "euler":
        xr, vr = ri.euler(x, v, m, eps, dt, 5, pairs)
    else:
        xr, vr, _ = ri.leapfrog(x, v, m, eps, dt, 5, pairs)
    assert (out.pos - xr).abs().max() < 1e-9 * (xr - x).abs().max()
    assert (out.vel - vr).abs().max() < 1e-9 * (vr - v).abs().max()


def test_rollout_gradient_matches_the_ports_rollout():
    from mini_nbody_tpu_torch import BodyState, SimConfig, sim

    x, v, m = bodies("plummer", n=128)
    eps, dt, steps = 1e-2, 1e-3, 4
    loss, grad = ri.rollout_grad(x, v, m, eps, dt, steps,
                                 ri.Pairs(torch.float64))
    cfg = SimConfig(n=128, dt=dt, softening=eps, integrator="leapfrog",
                    backend="torch", use_masses=True)
    with torch.no_grad():
        acc0 = sim.init_carry(cfg, BodyState(x, v, m))[1]
    p = x.clone().requires_grad_(True)
    out, _ = sim.make_rollout_fn(cfg, steps, "sqrt")(
        (BodyState(p, v, m), acc0))
    want_loss = (out.vel * out.vel).sum()
    want_loss.backward()
    assert float(loss) == pytest.approx(want_loss.item(), rel=1e-12)
    assert (grad - p.grad).abs().max() < 1e-9 * p.grad.abs().max()


def test_uniform_bodies_are_mini_nbodys():
    pos, vel, mass = inputs.make("uniform", (3, 1000), 11, "cpu")
    assert pos.shape == vel.shape == (3, 1000, 3)
    assert pos.dtype == torch.float32
    assert float(pos.min()) >= -1 and float(pos.max()) <= 1
    assert float(vel.min()) >= -1 and float(vel.max()) <= 1
    assert torch.all(mass == 1)
    again = inputs.make("uniform", (3, 1000), 11, "cpu")
    assert torch.equal(pos, again[0]) and torch.equal(vel, again[1])
    other = inputs.make("uniform", (3, 1000), 12, "cpu")
    assert not torch.equal(pos, other[0])


def test_plummer_bodies_are_in_virial_equilibrium():
    pos, vel, mass = inputs.make("plummer", 4096, 5, "cpu")
    x, v, m = pos.double(), vel.double(), mass.double()
    assert float(m.sum()) == pytest.approx(1.0, rel=1e-6)
    assert float((m[:, None] * x).sum(0).norm()) < 1e-6
    assert float((m[:, None] * v).sum(0).norm()) < 1e-6
    t, u = float(rf.kinetic(v, m)), float(rf.potential(x, m, 0.0))
    # 2T / |U| = 1 in equilibrium, and E = -1/4, so U = -1/2, in N-body
    # units
    assert 2 * t / abs(u) == pytest.approx(1.0, abs=0.1)
    assert u == pytest.approx(-0.5, rel=0.1)


def test_seeds_beyond_32_bits_draw_distinct_inputs():
    a = inputs.make("plummer", 64, 2**31 + 5, "cpu")[0]
    b = inputs.make("plummer", 64, 2**31 + 6, "cpu")[0]
    c = inputs.make("plummer", 64, 2**31 + 5, "cpu")[0]
    assert torch.equal(a, c) and not torch.equal(a, b)


def test_round_mantissa_keeps_that_many_bits():
    t = torch.tensor([1.3, 1.0625, 1.0, 1000.0, 3e-7, 1.125],
                     dtype=torch.float64)
    rf.round_mantissa_(t, 3)
    assert t.tolist() == pytest.approx([1.25, 1.0, 1.0, 1024.0,
                                        3e-7 * 1.0, 1.125], rel=0.07)
    assert t[0] == 1.25 and t[1] == 1.0 and t[5] == 1.125
    assert t[3] == 1024.0
    # every value now has at most 3 mantissa bits
    m, _ = torch.frexp(t)
    assert torch.equal(m * 16, (m * 16).round())
