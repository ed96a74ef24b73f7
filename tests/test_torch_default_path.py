"""The slice as a whole: the default path. The same JAX plummer state (as
numpy; N = 300, masses, softening 1e-2, dt 1e-3) goes through JAX
``simulate`` on its fp32 pair-once kernel (backend 'sym', interpret mode,
not resident) and through the port's ``simulate`` with the backend left at
'auto' on the CPU (sym's plain version), for 20 leapfrog steps.

pos and vel agree at rtol 1e-4, atol 1e-5 of their scale (the bound of
tests/test_torch_sim.py: fp32 on both sides, sums in another order,
compounded over the steps). E0 and E1 agree with JAX's total_energy within
1e-5 relative, and both drifts stay below the BASELINE gate 1e-5."""

import dataclasses

import jax
import numpy as np
import torch

from mini_nbody_tpu import sim as jsim
from mini_nbody_tpu.models import init as jinit
from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.ops import diagnostics as jdg
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import BodyState, SimConfig, simulate
from mini_nbody_tpu_torch.ops import diagnostics as dg
from mini_nbody_tpu_torch.ops import symmetric_force as sf

torch.set_num_threads(1)

N, STEPS = 300, 20
RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def test_default_path_20_leapfrog_steps_vs_jax():
    s = jinit.plummer(jax.random.key(0), N)
    pos, vel, mass = (np.asarray(a, np.float32) for a in (s.pos, s.vel,
                                                          s.mass))
    jcfg = JSimConfig(n=N, steps=STEPS, dt=1e-3, softening=1e-2,
                      integrator="leapfrog", backend="sym", use_masses=True,
                      sym_tile=64, sym_chunk=128, interpret=True,
                      resident=False)
    j0 = JBodyState.create(pos, vel, mass)
    j1 = jsim.simulate(jcfg, j0)

    cfg = SimConfig.from_dict(dataclasses.asdict(jcfg)).replace(
        backend="auto")
    assert cfg.effective_backend() == "sym"
    t0 = BodyState.from_numpy(pos, vel, mass, device="cpu")
    before = sf.LAUNCHES
    t1 = simulate(cfg, t0)
    assert sf.LAUNCHES == before  # CPU tensors: the plain version
    _close(t1.pos.numpy(), np.asarray(j1.pos))
    _close(t1.vel.numpy(), np.asarray(j1.vel))

    je0, je1 = (float(jdg.total_energy(x, 1e-2)) for x in (j0, j1))
    te0, te1 = (float(dg.total_energy(x, 1e-2)) for x in (t0, t1))
    for got, want in ((te0, je0), (te1, je1)):
        assert abs(got - want) <= 1e-5 * abs(want)
    assert float(jdg.energy_drift(je0, je1)) < 1e-5
    assert dg.energy_drift(te0, te1) < 1e-5
