"""Port vs JAX package: gradients through whole trajectories.

make_step_fn(cfg, differentiable=True) for the four integrators and
make_rollout_fn with remat "none", "step" and "sqrt" (and a ragged
steps=11, whose sqrt split leaves a remainder) against JAX's on the same
numpy state: the port's `torch` backend against JAX's `jnp`, and `sym`
(K3 and B11's plain versions) against JAX's `sym` in interpret mode at
n = 64 over 4 steps. The rollout loss is sum(vel_final^2), whose gradient
in the initial positions flows through the force VJPs alone: a zeroed or
sign-flipped VJP fails these comparisons. Also the two user paths of the
examples: the initial
velocity of a probe (examples/optimize_impact.py) and the masses
(examples/infer_masses.py).

Tolerances: across the packages, rtol 1e-3, atol 1e-4 of the gradient's
scale, the fp32 VJP bound (tests/test_autodiff.py:34); several steps
compound sums taken in another order, as in tests/test_autodiff.py:175,
which holds a 5-step gradient at atol 1e-3 of the scale against a jnp
autodiff reference. Within the port the remat policies are compared
bitwise: on the CPU a recomputed forward is the first one, so checkpointing
changes no number (JAX's own rollout tests allow rtol 1e-5,
tests/test_sim.py:210-225, for XLA's fusion differences)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu import sim as jsim
from mini_nbody_tpu.models import init as jinit
from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.ops import autodiff as ja
from mini_nbody_tpu.ops.integrators import leapfrog_step as j_leapfrog
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import (BodyState, SimConfig,
                                  make_differentiable_force, make_rollout_fn,
                                  make_step_fn, simulate)
from mini_nbody_tpu_torch.ops.integrators import leapfrog_step
from mini_nbody_tpu_torch.sim import init_carry

torch.set_num_threads(1)

TOL = (1e-3, 1e-4)
#: port backend -> JAX backend
JAX_NAME = {"torch": "jnp", "sym": "sym"}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1] * scale)


def _state(n, seed):
    s = jinit.plummer(jax.random.key(seed), n)
    return tuple(np.array(a, np.float32) for a in (s.pos, s.vel, s.mass))


def _cfgs(n, backend, **kw):
    kw = dict(dt=1e-3, softening=1e-2, use_masses=True, **kw)
    return (JSimConfig(n=n, backend=JAX_NAME[backend], sym_tile=64,
                       sym_bwd_tile=64, interpret=True, **kw),
            SimConfig(n=n, backend=backend, sym_tile=64, sym_bwd_tile=64,
                      **kw))


def _jax_rollout_grad(jcfg, steps, remat, pos, vel, mass):
    """JAX: grad and value of sum(vel_final^2) in the initial positions,
    the initial acceleration a constant (tests/test_sim.py:190-207). The
    final velocities depend on the initial positions only through the
    forces, so the whole gradient flows through the force VJPs (that of
    sum(pos_final^2) over a few short steps is 2 pos_final to ~1e-6)."""
    s = JBodyState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                   mass=jnp.asarray(mass))
    carry0 = jsim.init_carry(jcfg, s)
    roll = jsim.make_rollout_fn(jcfg, steps, remat=remat)

    def loss(pos0):
        out, _ = roll((dataclasses.replace(carry0[0], pos=pos0), carry0[1]))
        return jnp.sum(out.vel ** 2)

    return jax.value_and_grad(loss)(s.pos)


def _torch_rollout_grad(cfg, steps, remat, pos, vel, mass):
    s = BodyState.from_numpy(pos, vel, mass, device="cpu")
    carry0 = init_carry(cfg, s)
    p = s.pos.clone().requires_grad_(True)
    out, _ = make_rollout_fn(cfg, steps, remat)(
        (BodyState(pos=p, vel=s.vel, mass=s.mass), carry0[1]))
    loss = (out.vel ** 2).sum()
    loss.backward()
    return loss.detach(), p.grad


@pytest.mark.parametrize("integrator", ["leapfrog", "euler"])
@pytest.mark.parametrize("remat,steps", [("none", 10), ("step", 10),
                                         ("sqrt", 10), ("sqrt", 11)])
def test_rollout_grad_matches_jax(integrator, remat, steps):
    pos, vel, mass = _state(64, 21)
    jcfg, cfg = _cfgs(64, "torch", integrator=integrator)
    jl, jg = _jax_rollout_grad(jcfg, steps, remat, pos, vel, mass)
    tl, tg = _torch_rollout_grad(cfg, steps, remat, pos, vel, mass)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close(tg, jg)


@pytest.mark.parametrize("steps", [10, 11])
def test_remat_policies_agree_bitwise_on_the_cpu(steps):
    pos, vel, mass = _state(48, 22)
    _, cfg = _cfgs(48, "torch", integrator="leapfrog")
    out = [_torch_rollout_grad(cfg, steps, remat, pos, vel, mass)
           for remat in ("none", "step", "sqrt")]
    for loss, grad in out[1:]:
        assert torch.equal(loss, out[0][0]) and torch.equal(grad, out[0][1])


@pytest.mark.parametrize("remat", ["none", "sqrt"])
def test_rollout_on_sym_matches_jax_interpret(remat):
    # K3's and B11's plain versions against JAX's band kernels in interpret
    # mode: n = 64, 4 leapfrog steps.
    pos, vel, mass = _state(64, 23)
    jcfg, cfg = _cfgs(64, "sym", integrator="leapfrog")
    jl, jg = _jax_rollout_grad(jcfg, 4, remat, pos, vel, mass)
    tl, tg = _torch_rollout_grad(cfg, 4, remat, pos, vel, mass)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close(tg, jg)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "rk4",
                                        "yoshida4"])
def test_differentiable_step_matches_jax(integrator):
    # Three differentiable steps from init_carry; the gradient flows to the
    # initial positions and velocities.
    pos, vel, mass = _state(40, 24)
    jcfg, cfg = _cfgs(40, "torch", integrator=integrator)
    jstep = jsim.make_step_fn(jcfg, differentiable=True)

    def jloss(p, v):
        carry = jsim.init_carry(jcfg, JBodyState(pos=p, vel=v,
                                                 mass=jnp.asarray(mass)))
        for _ in range(3):
            carry = jstep(carry)
        return jnp.sum(carry[0].pos ** 2) + jnp.sum(carry[0].vel ** 2)

    jgp, jgv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pos),
                                                jnp.asarray(vel))
    step = make_step_fn(cfg, differentiable=True)
    p = torch.from_numpy(pos).requires_grad_(True)
    v = torch.from_numpy(vel).requires_grad_(True)
    # On the CPU the initial force is the plain all-pairs op, which
    # autograd differentiates as JAX differentiates its jnp force.
    carry = init_carry(cfg, BodyState(pos=p, vel=v,
                                      mass=torch.from_numpy(mass)))
    for _ in range(3):
        carry = step(carry)
    ((carry[0].pos ** 2).sum() + (carry[0].vel ** 2).sum()).backward()
    _close(p.grad, jgp)
    _close(v.grad, jgv)


def test_rollout_forward_is_simulate():
    pos, vel, mass = _state(64, 25)
    _, cfg = _cfgs(64, "torch", integrator="leapfrog")
    s = BodyState.from_numpy(pos, vel, mass, device="cpu")
    with torch.no_grad():
        out, _ = make_rollout_fn(cfg, 7)(init_carry(cfg, s))
    ref = simulate(cfg, s, steps=7)
    assert torch.equal(out.pos, ref.pos) and torch.equal(out.vel, ref.vel)


def test_probe_velocity_gradient_matches_jax():
    # examples/optimize_impact.py: body 0 is a probe whose initial velocity
    # is optimised so that it reaches a target; here the gradient of its
    # miss through a sqrt-checkpointed 12-step rollout, n = 64.
    pos, vel, mass = _state(64, 26)
    start, target = np.array([-1.5, -1.0, 0.0], np.float32), \
        np.array([1.2, 0.8, 0.0], np.float32)
    pos[0] = start
    # 3% short of the straight line: a miss of ~0.1, so the loss is not a
    # cancellation of nearly equal positions.
    v0 = 0.97 * (target - start) / (12 * 5e-3)
    jcfg = JSimConfig(n=64, dt=5e-3, softening=1e-2, integrator="leapfrog",
                      use_masses=True, backend="jnp")
    cfg = SimConfig.from_dict(dataclasses.asdict(jcfg))
    jroll = jsim.make_rollout_fn(jcfg, 12)

    def jloss(v):
        s = JBodyState(pos=jnp.asarray(pos),
                       vel=jnp.asarray(vel).at[0].set(v),
                       mass=jnp.asarray(mass))
        out, _ = jroll(jsim.init_carry(jcfg, s))
        return jnp.sum((out.pos[0] - jnp.asarray(target)) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(v0))
    roll = make_rollout_fn(cfg, 12)
    v = torch.from_numpy(v0).requires_grad_(True)
    tvel = torch.cat([v[None], torch.from_numpy(vel[1:])])
    s = BodyState(pos=torch.from_numpy(pos), vel=tvel,
                  mass=torch.from_numpy(mass))
    out, _ = roll(init_carry(cfg, s))
    loss = ((out.pos[0] - torch.from_numpy(target)) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    _close(v.grad, jg)


@pytest.mark.parametrize("backend", ["torch", "sym"])
def test_mass_gradient_through_a_trajectory_matches_jax(backend):
    # examples/infer_masses.py: d(loss)/d(masses) through 5 leapfrog steps
    # with the mass cotangent of every force pass.
    pos, vel, mass = _state(48, 27)
    jcfg, cfg = _cfgs(48, backend, integrator="leapfrog")
    jforce = ja.make_differentiable_force(jcfg, mass_grad=True)

    def jloss(m):
        def f3(pi, pj, mj):
            return jforce(pi, mj)

        st = JBodyState(pos=jnp.asarray(pos), vel=jnp.asarray(vel), mass=m)
        acc = f3(st.pos, st.pos, m)
        for _ in range(5):
            st, acc = j_leapfrog(st, acc, f3, jcfg.dt)
        return jnp.sum(st.vel ** 2)

    jg = jax.grad(jloss)(jnp.asarray(mass))
    force = make_differentiable_force(cfg, mass_grad=True)

    def f3(pi, pj, mj):
        return force(pi, mj)

    m = torch.from_numpy(mass).requires_grad_(True)
    st = BodyState(pos=torch.from_numpy(pos), vel=torch.from_numpy(vel),
                   mass=m)
    acc = f3(st.pos, st.pos, m)
    for _ in range(5):
        st, acc = leapfrog_step(st, acc, f3, cfg.dt)
    (st.vel ** 2).sum().backward()
    _close(m.grad, jg)


def test_bad_remat_and_fused_refusal():
    with pytest.raises(ValueError, match="remat"):
        make_rollout_fn(SimConfig(n=8), 4, remat="bogus")
    with pytest.raises(ValueError, match="fused_integrate"):
        make_rollout_fn(SimConfig(n=8, backend="direct",
                                  fused_integrate=True), 4)
