"""Port vs JAX package: the batched ensembles. body_force_sym_mxu_ensemble
(B9a's plain path on the CPU) and body_force_symmetric_ensemble (B9b's),
simulate_ensemble and trajectory_ensemble, the per-system duplicate scan,
the validation errors and the ensemble diagnostics, on the same numpy inputs
as the JAX package's ensembles in interpret mode (B = 3, N = 200, tile 64,
as tests/test_ensemble.py; ragged N 192, 300 and 128 at tiles 64 and 128).

Tolerances. The bf16 class (sym_mxu) against JAX's slot ensemble: rtol 0,
atol 5e-6 of the force scale, the bound of tests/test_torch_sym_mxu.py (on
the CPU both sides multiply in fp32 and differ only in the order of the
sums). The fp32 class (sym) against JAX's band ensemble: rtol 1e-4, atol
1e-5 of the scale, the bound of tests/test_torch_symmetric.py (fp32 sums
over another traversal). Trajectories: rtol 1e-4, atol 1e-5 of their scale
(tests/test_torch_sim.py). Energies |dE| <= 1e-5 |E|, momenta 1e-5 of
their scale (fp32 sums in another order). The port against itself: every
system bitwise its standalone call. Inputs are np.float32 arrays, since
tests/conftest.py turns on jax_enable_x64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu import sim as jsim
from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.ops import diagnostics as jdg
from mini_nbody_tpu.ops import sym_mxu_force as jsm
from mini_nbody_tpu.ops import symmetric_force as jsf
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import (BodyState, SimConfig, simulate,
                                  simulate_ensemble, trajectory,
                                  trajectory_ensemble)
from mini_nbody_tpu_torch.ops import diagnostics as dg
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.ops import symmetric_force as sf
from mini_nbody_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

B, N, TILE = 3, 200, 64
MXU_ATOL = 5e-6
RTOL, ATOL = 1e-4, 1e-5


def _systems(n=N, b=B, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    vel = (0.1 * rng.uniform(-1, 1, (b, n, 3))).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, (b, n)).astype(np.float32)
    return pos, vel, mass


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _scale(a):
    return max(float(np.abs(a).max()), 1.0)


def _close(got, want, mxu):
    got, want = np.asarray(got), np.asarray(want)
    if mxu:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=MXU_ATOL * _scale(want))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=ATOL * _scale(want))


def _jax_force(pos, mass, mxu, tile=TILE, softening=1e-2, **kw):
    if mxu:
        return np.asarray(jsm.body_force_sym_mxu_ensemble(
            _j(pos), _j(mass), softening=softening, tile=tile,
            interpret=True, traversal="slots", **kw))
    return np.asarray(jsf.body_force_symmetric_ensemble(
        _j(pos), _j(mass), softening=softening, tile=tile, interpret=True))


def _port_force(pos, mass, mxu, tile=TILE, softening=1e-2, **kw):
    if mxu:
        return sm.body_force_sym_mxu_ensemble(_t(pos), _t(mass), softening,
                                              tile=tile, **kw)
    return sf.body_force_symmetric_ensemble(_t(pos), _t(mass), softening,
                                            tile=tile)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_force_vs_jax(mxu, masses):
    pos, _, mass = _systems()
    m = mass if masses else None
    got = _port_force(pos, m, mxu)
    assert got.shape == (B, N, 3) and got.dtype == torch.float32
    _close(got, _jax_force(pos, m, mxu), mxu)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("n,tile", [(192, 64), (300, 64), (128, 128)])
def test_force_parities_vs_jax(mxu, n, tile):
    # nb = 3 (odd), 5 (odd, ragged tail), 1 (one diagonal block).
    pos, _, mass = _systems(n, seed=1)
    _close(_port_force(pos, mass, mxu, tile), _jax_force(pos, mass, mxu,
                                                         tile), mxu)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("n,tile", [(N, TILE), (192, 64), (300, 64),
                                    (128, 128), (N, None)])
def test_force_bitwise_vs_standalone(mxu, masses, n, tile):
    # The default softening 1e-9: close pairs, and exact agreement all the
    # same.
    pos, _, mass = _systems(n, seed=2)
    m = mass if masses else None
    f = _port_force(pos, m, mxu, tile, softening=1e-9)
    t, c = sm.ensemble_tiling(n, tile, kernel=False)
    for i in range(B):
        mi = None if m is None else _t(m[i])
        ref = (sm.body_force_sym_mxu(_t(pos[i]), mi, tile=t, chunk=c) if mxu
               else sf.body_force_symmetric(_t(pos[i]), mi, tile=t, chunk=c))
        assert torch.equal(f[i], ref), i


def test_ensemble_tiling():
    # On the card: the tile of 64 and 128 that pads less pair work, ties to
    # 128; a named tile stays. On the CPU: the plain path's rule.
    assert sm.ensemble_tiling(1024, None, kernel=True) == (128, 1024)
    assert sm.ensemble_tiling(200, None, kernel=True) == (128, 256)
    assert sm.ensemble_tiling(130, None, kernel=True) == (64, 192)
    assert sm.ensemble_tiling(64, None, kernel=True) == (64, 64)
    assert sm.ensemble_tiling(200, 64, kernel=True) == (64, 256)
    for n, tile in ((200, None), (200, 64), (7, None), (300, 128)):
        t = sm.DEFAULT_TILE if tile is None else tile
        want = sm._resolve_tiling(n, t, n, kernel=False)
        assert sm.ensemble_tiling(n, tile, kernel=False) == want[:2]
    assert sf.ensemble_tiling is sm.ensemble_tiling


def _cfgs(backend, integrator, masses=True, steps=3, n=N):
    kw = dict(n=n, dt=1e-3, steps=steps, softening=1e-2,
              integrator=integrator, use_masses=masses, sym_tile=TILE)
    return (JSimConfig(backend=backend, interpret=True, resident=False,
                       **kw),
            SimConfig(backend=backend, **kw))


def _states(pos, vel, mass):
    return (JBodyState(pos=_j(pos), vel=_j(vel), mass=_j(mass)),
            BodyState.from_numpy(pos, vel, mass, device="cpu"))


@pytest.mark.parametrize("backend", ["sym", "sym_mxu"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_simulate_ensemble_vs_jax(backend, integrator):
    pos, vel, mass = _systems(seed=3)
    jcfg, cfg = _cfgs(backend, integrator)
    js, ts = _states(pos, vel, mass)
    want = jsim.simulate_ensemble(jcfg, js)
    got = simulate_ensemble(cfg, ts)
    for g, w in ((got.pos, want.pos), (got.vel, want.vel)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * _scale(w))
    assert torch.equal(got.mass, ts.mass)


@pytest.mark.parametrize("backend", ["auto", "sym_mxu"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
@pytest.mark.parametrize("masses", [False, True])
def test_simulate_ensemble_bitwise_vs_simulate(backend, integrator, masses):
    pos, vel, mass = _systems(seed=4)
    _, cfg = _cfgs(backend, integrator, masses)
    out = simulate_ensemble(cfg, BodyState.from_numpy(pos, vel, mass,
                                                      device="cpu"))
    t, c = sm.ensemble_tiling(N, TILE, kernel=False)
    for i in range(B):
        ref = simulate(cfg.replace(sym_tile=t, sym_chunk=c),
                       BodyState.from_numpy(pos[i], vel[i], mass[i],
                                            device="cpu"))
        assert torch.equal(out.pos[i], ref.pos), i
        assert torch.equal(out.vel[i], ref.vel), i


@pytest.mark.parametrize("backend", ["sym", "sym_mxu"])
def test_trajectory_ensemble_vs_jax_and_trajectory(backend):
    pos, vel, mass = _systems(seed=5)
    jcfg, cfg = _cfgs(backend, "leapfrog", steps=6)
    js, ts = _states(pos, vel, mass)
    jout, jhist = jsim.trajectory_ensemble(jcfg, js, save_every=2)
    out, hist = trajectory_ensemble(cfg, ts, save_every=2)
    assert hist.shape == (3, B, N, 3) == jhist.shape
    jhist = np.asarray(jhist)
    np.testing.assert_allclose(hist.numpy(), jhist, rtol=RTOL,
                               atol=ATOL * _scale(jhist))
    assert torch.equal(hist[-1], out.pos)
    t, c = sm.ensemble_tiling(N, TILE, kernel=False)
    for i in range(B):
        ref, rhist = trajectory(cfg.replace(sym_tile=t, sym_chunk=c),
                                BodyState.from_numpy(pos[i], vel[i], mass[i],
                                                     device="cpu"),
                                6, save_every=2)
        assert torch.equal(hist[:, i], rhist), i
        assert torch.equal(out.vel[i], ref.vel), i


def _record_mask(monkeypatch):
    """Record the mask_offdiag of every B9a call."""
    seen = []
    real = sp.tri_slot_sums_ensemble_

    def spy(*args, **kw):
        seen.append(args[8] if len(args) > 8 else kw["mask_offdiag"])
        return real(*args, **kw)

    monkeypatch.setattr(sp, "tri_slot_sums_ensemble_", spy)
    return seen


def test_cross_system_duplicates_stay_maskless(monkeypatch):
    # Two identical systems: every body is duplicated ACROSS systems, none
    # within one. With the gate at 0 'auto' scans, finds nothing and takes
    # the maskless kernel, bitwise 'fast'; both systems get equal forces.
    monkeypatch.setattr(sm, "COINCIDENT_AUTO_MIN_N", 0)
    pos, _, _ = _systems(b=1, seed=6)
    pos = np.concatenate([pos, pos])
    assert sm.any_coincident(_t(pos).reshape(-1, 3))
    assert not sm.any_coincident_ensemble(_t(pos))
    seen = _record_mask(monkeypatch)
    fa = _port_force(pos, None, True, coincident="auto")
    ff = _port_force(pos, None, True, coincident="fast")
    assert seen == [False, False]
    assert torch.equal(fa, ff) and torch.equal(fa[0], fa[1])
    _close(fa, _jax_force(pos, None, True, coincident="auto"), True)


def test_within_system_duplicate_routes_masked(monkeypatch):
    monkeypatch.setattr(sm, "COINCIDENT_AUTO_MIN_N", 0)
    pos, _, _ = _systems(b=2, seed=7)
    pos[1, 150] = pos[1, 3]
    assert sm.any_coincident_ensemble(_t(pos))
    seen = _record_mask(monkeypatch)
    fa = _port_force(pos, None, True, coincident="auto")
    fm = _port_force(pos, None, True, coincident="masked")
    assert seen == [True, True]
    assert torch.equal(fa, fm) and torch.isfinite(fa).all()
    _close(fa, _jax_force(pos, None, True, coincident="masked"), True)


@pytest.mark.parametrize("case", ["duplicate", "tiny", "far", "clean"])
def test_any_coincident_ensemble_is_the_per_system_scan(case):
    pos, _, _ = _systems(n=50, b=4, seed=8)
    if case == "duplicate":
        pos[2, 40] = pos[2, 7]
    elif case == "tiny":
        pos[3, 5, 1] = 1e-20
    elif case == "far":
        pos[0, 9, 2] = 2e18
    want = any(sm.any_coincident(_t(p)) for p in pos)
    assert sm.any_coincident_ensemble(_t(pos)) == want == (case != "clean")


def test_auto_below_the_gate_is_masked_without_a_scan(monkeypatch):
    pos, _, _ = _systems(seed=9)
    monkeypatch.setattr(sm, "any_coincident_ensemble",
                        lambda p: pytest.fail("scanned below the gate"))
    seen = _record_mask(monkeypatch)
    _port_force(pos, None, True, coincident="auto")
    assert seen == [True]


def test_validation():
    pos, vel, mass = _systems()
    cfg = SimConfig(n=N, backend="sym_mxu")
    state = BodyState.from_numpy(pos, vel, mass, device="cpu")
    one = BodyState.from_numpy(pos[0], vel[0], mass[0], device="cpu")
    for fn in (sm.body_force_sym_mxu_ensemble,
               sf.body_force_symmetric_ensemble):
        with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
            fn(_t(pos[0]))
        with pytest.raises(ValueError, match=r"\(B, N\)"):
            fn(_t(pos), _t(mass[0]))
    with pytest.raises(ValueError, match="coincident"):
        sm.body_force_sym_mxu_ensemble(_t(pos), coincident="no")
    # The band ensemble is ported (B16, tests/test_torch_band.py).
    band = sm.body_force_sym_mxu_ensemble(_t(pos), traversal="band")
    assert band.shape == pos.shape and torch.isfinite(band).all()
    with pytest.raises(ValueError, match="traversal"):
        sm.body_force_sym_mxu_ensemble(_t(pos), traversal="rows")
    with pytest.raises(ValueError, match="batched"):
        simulate_ensemble(cfg, one)
    with pytest.raises(ValueError, match="sym_mxu"):
        simulate_ensemble(cfg.replace(backend="direct"), state)
    with pytest.raises(ValueError, match="cfg.n"):
        simulate_ensemble(cfg.replace(n=N + 1), state)
    with pytest.raises(TypeError, match="Mesh"):
        simulate_ensemble(cfg, state, mesh=object())
    # B = 3 systems do not split over two ranks (refused before any
    # collective, so this rank's view of the mesh is enough).
    two = Mesh((2,), (0,), 0, torch.device("cpu"), None, {})
    for fn in (simulate_ensemble, trajectory_ensemble):
        with pytest.raises(ValueError, match="divisible by the mesh size"):
            fn(cfg, state, mesh=two)
    with pytest.raises(ValueError, match="divisible"):
        trajectory_ensemble(cfg.replace(steps=5), state, save_every=2)
    with pytest.raises(ValueError, match="systems"):
        sf.symmetric_sums_ensemble_(torch.zeros((300, 3)),
                                    torch.zeros((300, 3)),
                                    sp.slot_table(1, False, False, "cpu"),
                                    64, 1e-2, 7)


def test_auto_backend_runs_the_fp32_ensemble():
    pos, vel, mass = _systems(seed=10)
    _, cfg = _cfgs("auto", "euler", steps=2)
    state = BodyState.from_numpy(pos, vel, mass, device="cpu")
    got = simulate_ensemble(cfg, state)
    want = simulate_ensemble(cfg.replace(backend="sym"), state)
    assert torch.equal(got.pos, want.pos) and torch.equal(got.vel, want.vel)


def test_ensemble_diagnostics_vs_jax():
    pos, vel, mass = _systems(seed=11)
    js, ts = _states(pos, vel, mass)
    es = dg.total_energy_ensemble(ts, 1e-2)
    ps = dg.momentum_ensemble(ts)
    assert es.shape == (B,) and ps.shape == (B, 3)
    jes = np.asarray(jdg.total_energy_ensemble(js, 1e-2))
    jps = np.asarray(jdg.momentum_ensemble(js))
    np.testing.assert_allclose(es.numpy(), jes, rtol=1e-5)
    np.testing.assert_allclose(ps.numpy(), jps, rtol=0,
                               atol=1e-5 * _scale(jps))
    for i in range(B):
        one = BodyState.from_numpy(pos[i], vel[i], mass[i], device="cpu")
        assert torch.equal(es[i], dg.total_energy(one, 1e-2))
        assert torch.allclose(ps[i], dg.momentum(one), rtol=1e-6, atol=1e-6)
