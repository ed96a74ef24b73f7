"""The slice as a whole: the same numpy state through JAX ``simulate``
(jnp, pallas and sym_mxu in interpret mode) and the port's ``simulate``
(torch, direct and sym_mxu on the CPU, i.e. the kernels' plain versions),
10 Euler and 10 leapfrog steps at N=256; the other integrators; and
chip_smoke.py refusing to run without a card.

Softening 1e-2 keeps the 256-body cloud free of close encounters, so the
trajectories stay smooth and the comparison measures the port, not chaos.
Positions and velocities are held at rtol 1e-4, atol 1e-5 of their scale:
both sides are fp32 and differ in summation order, and ten steps compound
that by a few ulps. Inputs are np.float32 arrays, since tests/conftest.py
turns on jax_enable_x64 and float64 inputs would run the JAX side in f64."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mini_nbody_tpu import sim as jsim
from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import BodyState, SimConfig, make_step_fn, simulate
from mini_nbody_tpu_torch.sim import init_carry
from mini_nbody_tpu_torch.utils.harness import (FLOPS_PER_INTERACTION,
                                                Throughput, time_step_fn)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
BACKENDS = [("jnp", "torch"), ("pallas", "direct"), ("sym_mxu", "sym_mxu")]


def _np_state(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(-1, 1, (n, 3)).astype(np.float32) * 0.1,
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def _run_both(jax_backend, integrator, steps, n=256, use_masses=False):
    pos, vel, mass = _np_state(n)
    jcfg = JSimConfig(n=n, steps=steps, softening=1e-2, backend=jax_backend,
                      integrator=integrator, use_masses=use_masses,
                      sym_tile=64, interpret=True)
    j = jsim.simulate(jcfg, JBodyState.create(pos, vel, mass))
    cfg = SimConfig.from_dict(dataclasses.asdict(jcfg))
    t = simulate(cfg, BodyState.from_numpy(pos, vel, mass,
                                           device="cpu"))
    return (np.asarray(j.pos), np.asarray(j.vel)), t.to_numpy()[:2]


def _close(got, want):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("jax_backend,port_backend", BACKENDS)
def test_simulate_10_steps_vs_jax(jax_backend, port_backend, integrator):
    (jp, jv), (tp, tv) = _run_both(jax_backend, integrator, 10)
    assert SimConfig.from_dict({"n": 8, "backend": jax_backend}).backend \
        == port_backend
    _close(tp, jp)
    _close(tv, jv)


@pytest.mark.parametrize("integrator", ["rk4", "yoshida4"])
def test_other_integrators_vs_jax(integrator):
    (jp, jv), (tp, tv) = _run_both("jnp", integrator, 3, n=128,
                                   use_masses=True)
    _close(tp, jp)
    _close(tv, jv)


def test_step_fn_and_carry():
    pos, vel, mass = _np_state(64)
    cfg = SimConfig(n=64, integrator="leapfrog", backend="direct",
                    softening=1e-2)
    state = BodyState.from_numpy(pos, vel, mass, device="cpu")
    carry = init_carry(cfg, state)
    assert carry[1].abs().max() > 0  # leapfrog carries F(x0)
    s1, _ = make_step_fn(cfg)(carry)
    s2 = simulate(cfg, state, steps=1)
    assert torch.equal(s1.pos, s2.pos) and torch.equal(s1.vel, s2.vel)
    assert torch.equal(init_carry(cfg.replace(integrator="euler"),
                                  state)[1], torch.zeros(64, 3))
    # The differentiable step takes the same force forward: bitwise equal.
    s3, _ = make_step_fn(cfg, differentiable=True)(carry)
    assert torch.equal(s3.pos, s1.pos) and torch.equal(s3.vel, s1.vel)


def test_throughput_and_timing_refuse_the_cpu():
    t = Throughput(n=1 << 20, steps=2, seconds=4.0)
    assert t.interactions == 2.0 * (1 << 40)
    assert t.ginteractions_per_s == pytest.approx(2.0 * (1 << 40) / 4e9)
    assert t.gflops == pytest.approx(t.ginteractions_per_s
                                     * FLOPS_PER_INTERACTION)
    assert t.report()["per_device"] == t.ginteractions_per_s
    pos, vel, mass = _np_state(8)
    cfg = SimConfig(n=8, backend="torch")
    carry = init_carry(cfg, BodyState.from_numpy(pos, vel, mass,
                                                 device="cpu"))
    with pytest.raises(RuntimeError):
        time_step_fn(make_step_fn(cfg), carry)


def _smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_fails_without_cuda():
    proc = _smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
