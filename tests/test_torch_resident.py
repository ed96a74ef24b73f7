"""Port vs JAX package: the resident trajectory (B15's plain path on the
CPU). simulate_resident_sym, simulate_resident_sym_ensemble, the leapfrog
and Yoshida-4 drivers, single and ensemble, and simulate /
simulate_ensemble with resident=True, on the same numpy inputs as the JAX
package's resident kernel in interpret mode (N <= 300, at most 4 steps,
tiles 64 and 128); then the port against itself, the routing and the
validation.

Tolerances: rtol 1e-4, atol 1e-5 of the scale, the bound the JAX package
holds its resident kernel to against the streamed loop
(tests/test_resident_sym.py:21-48). On the CPU both sides of the bf16 class
multiply in fp32 (JAX's interpreter does not round its matmuls, and the
plain version runs fp32 products), so both classes take that bound. The
port against itself: a Yoshida-4 phase split, every ensemble system and
'auto' against 'masked' are bitwise.

C4, a deliberate split from the reference: the port zeroes w on every
pair that touches a pad, whatever coincident says; JAX's 'fast' fold gives
FAR-vs-FAR pad pairs softening^-1.5 weights that integrate every step. So
the parity tests avoid that one case (ragged N, fold, 'fast'), and a port
test pins it: finite, and within the bound of 'masked'. Inputs are
np.float32 arrays, since tests/conftest.py turns on jax_enable_x64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu import sim as jsim
from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.ops import resident_sym as jr
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import (BodyState, SimConfig, simulate,
                                  simulate_ensemble)
from mini_nbody_tpu_torch import sim as tsim
from mini_nbody_tpu_torch.ops import resident_sym as rs
from mini_nbody_tpu_torch.utils import tracing

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
DT = 1e-3


def _state(n, masses=True, seed=0, b=None):
    rng = np.random.default_rng(seed + n)
    shape = (n, 3) if b is None else (b, n, 3)
    pos = rng.uniform(-1, 1, shape).astype(np.float32)
    vel = (0.1 * rng.normal(size=shape)).astype(np.float32)
    mass = (rng.uniform(0.5, 2.0, shape[:-1]).astype(np.float32)
            if masses else None)
    return pos, vel, mass


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _pair_close(got, want):
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


JAX_DRIVERS = {"euler": jr.simulate_resident_sym,
               "leapfrog": jr.simulate_resident_sym_leapfrog,
               "yoshida4": jr.simulate_resident_sym_yoshida4}
PORT_DRIVERS = {"euler": rs.simulate_resident_sym,
                "leapfrog": rs.simulate_resident_sym_leapfrog,
                "yoshida4": rs.simulate_resident_sym_yoshida4}


def _vs_jax(n, steps, masses=False, mxu=False, integrator="euler", tile=64,
            softening=1e-2, fold=False, coincident="auto", seed=0):
    pos, vel, mass = _state(n, masses, seed)
    kw = dict(steps=steps, dt=DT, softening=softening, mxu=mxu, tile=tile,
              coincident=coincident)
    jkw = dict(kw, fold=fold) if integrator == "euler" else kw
    want = JAX_DRIVERS[integrator](_j(pos), _j(vel), _j(mass),
                                   interpret=True, **jkw)
    got = PORT_DRIVERS[integrator](_t(pos), _t(vel), _t(mass), fold=fold,
                                   **kw)
    _pair_close(got, want)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("fold", [False, True])
def test_euler_vs_jax(mxu, masses, fold):
    _vs_jax(256, 4, masses, mxu, fold=fold)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("n,steps,tile", [
    (300, 3, 64),   # ragged tail, FAR pads, nb = 5
    (100, 1, 128),  # one step, one block
    (320, 3, 64),   # nb = 5: odd block count
    (256, 3, 128),  # nb = 2: even
])
def test_euler_shapes_vs_jax(mxu, n, steps, tile):
    _vs_jax(n, steps, True, mxu, tile=tile, fold=True)


@pytest.mark.parametrize("mxu", [False, True])
def test_default_softening_self_pairs_vs_jax(mxu):
    _vs_jax(128, 2, False, mxu, softening=1e-9)


@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4"])
@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_kdk_drivers_vs_jax(integrator, mxu, masses):
    _vs_jax(200, 4, masses, mxu, integrator)


@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4"])
def test_kdk_drivers_one_step_and_ragged_vs_jax(integrator):
    # leapfrog with one step never enters the kernel; Yoshida-4 with one
    # step runs its 2 interior substeps.
    _vs_jax(100, 1, False, False, integrator, tile=128)
    _vs_jax(300, 3, True, True, integrator, tile=64)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_fast_vs_jax(mxu, masses):
    # No pads (N a multiple of the tile), so JAX's fold question (C4) does
    # not arise; 'fast' drops the off-diagonal mask of real bodies alone.
    _vs_jax(256, 3, masses, mxu, fold=True, coincident="fast")


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_ensemble_vs_jax(mxu, masses):
    pos, vel, mass = _state(192, masses, seed=1, b=3)
    kw = dict(steps=3, dt=DT, softening=1e-2, mxu=mxu, tile=64)
    want = jr.simulate_resident_sym_ensemble(_j(pos), _j(vel), _j(mass),
                                             interpret=True, fold=True, **kw)
    got = rs.simulate_resident_sym_ensemble(_t(pos), _t(vel), _t(mass),
                                            fold=True, **kw)
    _pair_close(got, want)


@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4"])
@pytest.mark.parametrize("mxu", [False, True])
def test_ensemble_kdk_drivers_vs_jax(integrator, mxu):
    pos, vel, mass = _state(200, True, seed=2, b=2)
    kw = dict(steps=3, dt=DT, softening=1e-2, mxu=mxu, tile=64)
    jfn = (jr.simulate_resident_sym_ensemble_leapfrog
           if integrator == "leapfrog"
           else jr.simulate_resident_sym_ensemble_yoshida4)
    tfn = (rs.simulate_resident_sym_ensemble_leapfrog
           if integrator == "leapfrog"
           else rs.simulate_resident_sym_ensemble_yoshida4)
    want = jfn(_j(pos), _j(vel), _j(mass), interpret=True, **kw)
    got = tfn(_t(pos), _t(vel), _t(mass), **kw)
    _pair_close(got, want)


def test_y4_cycle_is_jax():
    assert rs.y4_cycle(1e-3) == jr.y4_cycle(1e-3)
    assert rs.y4_cycle(0.37) == jr.y4_cycle(0.37)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
@pytest.mark.parametrize("backend", ["auto", "sym_mxu"])
def test_simulate_resident_vs_jax(integrator, backend):
    n = 192
    pos, vel, mass = _state(n, True, seed=3)
    kw = dict(n=n, dt=DT, steps=4, softening=1e-2, use_masses=True,
              integrator=integrator, backend=backend, resident=True)
    want = jsim.simulate(JSimConfig(interpret=True, **kw),
                         JBodyState(_j(pos), _j(vel), _j(mass)))
    got = simulate(SimConfig(**kw), BodyState(_t(pos), _t(vel), _t(mass)))
    _pair_close((got.pos, got.vel), (want.pos, want.vel))


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_simulate_ensemble_resident_vs_jax(integrator):
    n, b = 192, 3
    pos, vel, mass = _state(n, True, seed=4, b=b)
    kw = dict(n=n, dt=DT, steps=3, softening=1e-2, use_masses=True,
              integrator=integrator, backend="sym_mxu", sym_tile=64,
              resident=True, resident_tile=64)
    want = jsim.simulate_ensemble(JSimConfig(interpret=True, **kw),
                                  JBodyState(_j(pos), _j(vel), _j(mass)))
    got = simulate_ensemble(SimConfig(**kw),
                            BodyState(_t(pos), _t(vel), _t(mass)))
    _pair_close((got.pos, got.vel), (want.pos, want.vel))


# ------------------------------------------------ the port on its own

@pytest.mark.parametrize("mxu", [False, True])
def test_y4_phase_split_bitwise(mxu):
    pos, vel, mass = _state(200, True, seed=5)
    cycle, _ = rs.y4_cycle(DT)
    kw = dict(dt=DT, softening=1e-2, mxu=mxu, tile=64, y4=cycle)
    one = rs.simulate_resident_sym(_t(pos), _t(vel), _t(mass), steps=8,
                                   **kw)
    p, v = _t(pos), _t(vel)
    for start, k in ((0, 3), (3, 4), (7, 1)):
        p, v = rs.simulate_resident_sym(p, v, _t(mass), steps=k,
                                        y4_phase=start, **kw)
    assert torch.equal(p, one[0]) and torch.equal(v, one[1])


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("fold", [False, True])
def test_ensemble_bitwise_vs_standalone(mxu, masses, fold):
    pos, vel, mass = _state(300, masses, seed=6, b=3)
    kw = dict(steps=3, dt=DT, softening=1e-2, mxu=mxu, tile=64, fold=fold)
    p, v = rs.simulate_resident_sym_ensemble(_t(pos), _t(vel), _t(mass),
                                             **kw)
    for i in range(3):
        pi, vi = rs.simulate_resident_sym(
            _t(pos[i]), _t(vel[i]), None if mass is None else _t(mass[i]),
            **kw)
        assert torch.equal(p[i], pi) and torch.equal(v[i], vi), i


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_simulate_ensemble_resident_bitwise_vs_simulate(integrator):
    n, b = 300, 3
    pos, vel, mass = _state(n, True, seed=7, b=b)
    cfg = SimConfig(n=n, dt=DT, steps=3, softening=1e-2, use_masses=True,
                    integrator=integrator, backend="sym_mxu", sym_tile=64,
                    resident=True, resident_tile=64)
    out = simulate_ensemble(cfg, BodyState(_t(pos), _t(vel), _t(mass)))
    for i in range(b):
        one = simulate(cfg, BodyState(_t(pos[i]), _t(vel[i]), _t(mass[i])))
        assert torch.equal(out.pos[i], one.pos), i
        assert torch.equal(out.vel[i], one.vel), i


@pytest.mark.parametrize("mxu", [False, True])
def test_auto_is_masked_and_fold_matches_nofold(mxu):
    pos, vel, mass = _state(192, True, seed=8)
    kw = dict(steps=5, dt=DT, softening=1e-9, mxu=mxu, tile=64)
    run = {(mode, fold): rs.simulate_resident_sym(
        _t(pos), _t(vel), _t(mass), coincident=mode, fold=fold, **kw)
        for mode in ("auto", "masked") for fold in (False, True)}
    for fold in (False, True):
        assert torch.equal(run["auto", fold][0], run["masked", fold][0])
        assert torch.equal(run["auto", fold][1], run["masked", fold][1])
    _pair_close(run["masked", True], run["masked", False])


@pytest.mark.parametrize("mxu", [False, True])
def test_fast_fold_over_pads_stays_finite(mxu):
    # C4. N = 200 at tile 64: 56 pads in block 3, folded with block 2; the
    # default softening, unit masses (the pads' operand is [FAR | 1]), 30
    # steps. JAX's path is not held to this case (module docstring).
    pos, vel, _ = _state(200, False, seed=9)
    kw = dict(steps=30, dt=DT, softening=1e-9, mxu=mxu, tile=64, fold=True)
    fast = rs.simulate_resident_sym(_t(pos), _t(vel), None,
                                    coincident="fast", **kw)
    masked = rs.simulate_resident_sym(_t(pos), _t(vel), None,
                                      coincident="masked", **kw)
    for a in fast:
        assert torch.isfinite(a).all()
    _pair_close(fast, masked)


def test_pads_never_move():
    # The plain schedule on padded rows: the pads keep their FAR position
    # and zero velocity, in both classes, under 'fast' and a fold.
    n, tile = 200, 64
    pos, vel, _ = _state(n, False, seed=10)
    for mxu in (False, True):
        p = torch.cat([_t(pos), torch.full((56, 3), 1.0e18)])[None]
        v = torch.cat([_t(vel), torch.zeros((56, 3))])[None]
        slots = rs.slot_pipe.slot_table(4, True, False, "cpu")
        rs.resident_plain(p, v, None, slots, tile, n, 5, DT, 1e-9, mxu,
                          False)
        assert torch.equal(p[0, n:], torch.full((56, 3), 1.0e18))
        assert torch.equal(v[0, n:], torch.zeros((56, 3)))


def test_zero_mass_sources_inert():
    n = 128
    pos, vel, _ = _state(n, False, seed=11)
    mass = np.ones(n, np.float32)
    mass[n // 2:] = 0.0
    p, _ = rs.simulate_resident_sym(_t(pos), _t(vel), _t(mass), steps=2,
                                    dt=DT, softening=1e-2, tile=64)
    h = n // 2
    p2, _ = rs.simulate_resident_sym(_t(pos[:h]), _t(vel[:h]),
                                     _t(mass[:h]), steps=2, dt=DT,
                                     softening=1e-2, tile=64)
    np.testing.assert_allclose(p[:h].numpy(), p2.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_leaves_its_inputs_alone():
    # The run updates its own padded copy; with no pads that copy must
    # still not be the caller's tensor.
    pos, vel, mass = _state(128, True, seed=12)
    p, v, m = _t(pos), _t(vel), _t(mass)
    rs.simulate_resident_sym(p, v, m, steps=2, dt=DT, softening=1e-2,
                             tile=64)
    assert np.array_equal(p.numpy(), pos) and np.array_equal(v.numpy(), vel)


# ----------------------------------------------------------- routing

def test_resident_true_runs_the_plain_schedule_on_the_cpu(monkeypatch):
    calls = []
    plain = rs.resident_plain

    def counted(*a, **k):
        calls.append(a[4])  # the tile
        return plain(*a, **k)

    monkeypatch.setattr(rs, "resident_plain", counted)
    pos, vel, mass = _state(192, True, seed=13)
    cfg = SimConfig(n=192, dt=DT, steps=3, softening=1e-2, use_masses=True,
                    resident=True, resident_tile=64)
    before = tracing.counters()
    out = simulate(cfg, BodyState(_t(pos), _t(vel), _t(mass)))
    moved = tracing.counters() - before
    assert calls == [64] and not [k for k in moved if k.startswith("launch.")]
    ref = simulate(cfg.replace(resident=False),
                   BodyState(_t(pos), _t(vel), _t(mass)))
    _pair_close((out.pos, out.vel), (ref.pos, ref.vel))


def test_auto_never_routes_on_the_cpu(monkeypatch):
    monkeypatch.setitem(tsim.RESIDENT_AUTO_MAX_N, "sym", 1 << 30)
    monkeypatch.setitem(tsim.RESIDENT_ENSEMBLE_AUTO_MAX_N, "sym", 1 << 30)
    monkeypatch.setattr(rs, "resident_plain", None)  # a call would raise
    cpu = torch.device("cpu")
    cfg = SimConfig(n=64, steps=4)
    assert not tsim._route_resident(cfg, 4, cpu)
    assert not tsim._route_resident_ensemble(cfg, 4, 2, cpu)
    pos, vel, mass = _state(64, True, seed=14)
    simulate(cfg, BodyState(_t(pos), _t(vel), _t(mass)))


def test_auto_routing_rules(monkeypatch):
    cuda = torch.device("cuda")
    # Crossovers for the bf16 class alone: the fp32 class never routes.
    monkeypatch.setattr(tsim, "RESIDENT_AUTO_MAX_N", {"sym_mxu": 4096})
    monkeypatch.setattr(tsim, "RESIDENT_ENSEMBLE_AUTO_MAX_N",
                        {"sym_mxu": 1024})
    monkeypatch.setattr(tsim, "RESIDENT_AUTO_MIN_STEPS",
                        {"euler": 2, "leapfrog": 3, "yoshida4": 5})
    base = SimConfig(n=1024, steps=4, backend="sym_mxu", integrator="euler")
    assert tsim._route_resident(base, 4, cuda)
    assert tsim._route_resident_ensemble(base, 4, 8, cuda)
    assert not tsim._route_resident(base, 1, cuda)  # below the fewest steps
    for integ, fewest in (("leapfrog", 3), ("yoshida4", 5)):
        cfg = base.replace(integrator=integ)
        assert not tsim._route_resident(cfg, fewest - 1, cuda)
        assert not tsim._route_resident_ensemble(cfg, fewest - 1, 8, cuda)
        assert tsim._route_resident(cfg, fewest, cuda)
        assert tsim._route_resident_ensemble(cfg, fewest, 8, cuda)
    # More than one streamed chunk: B15's one slot list is not its bits.
    assert not tsim._route_resident(base.replace(sym_chunk=512), 4, cuda)
    assert tsim._route_resident(base.replace(sym_chunk=1024), 4, cuda)
    assert not tsim._route_resident(base.replace(n=8192), 4, cuda)
    assert not tsim._route_resident(base.replace(backend="sym"), 4, cuda)
    assert not tsim._route_resident_ensemble(base.replace(n=2048), 4, 8,
                                             cuda)
    assert not tsim._route_resident_ensemble(base, 4, 256, cuda)  # > cap
    for bad in (dict(integrator="rk4"), dict(split_w=True),
                dict(backend="direct", fused_integrate=True),
                dict(resident=False)):
        cfg = base.replace(**bad)
        assert not tsim._route_resident(cfg, 4, cuda), bad
        assert not tsim._route_resident_ensemble(cfg, 4, 8, cuda), bad
    assert not tsim._route_resident(base.replace(resident=True), 0, cuda)
    forced = base.replace(resident=True, n=131072)
    assert tsim._route_resident(forced, 4, torch.device("cpu"))
    assert not tsim._route_resident_ensemble(forced, 4, 64, cuda)


def test_routed_tile_is_the_streamed_tile():
    # A routed run takes the streamed path's tile, so the route changes no
    # bit: resident_tile, else sym_tile, else the streamed default (one
    # system) or the ensemble's own tiling (None).
    base = SimConfig(n=3000, steps=4, backend="sym_mxu")
    assert tsim._resident_tile(base, False) == 128
    assert tsim._resident_tile(base, True) is None
    for kw, tile in ((dict(sym_tile=64), 64), (dict(resident_tile=64), 64),
                     (dict(sym_tile=64, resident_tile=128), 128)):
        assert tsim._resident_tile(base.replace(**kw), False) == tile
        assert tsim._resident_tile(base.replace(**kw), True) == tile


def test_leapfrog_substep_is_the_streamed_kdk():
    # The resident leapfrog's interior substep (dt / 2, dt / 2, dt) applied
    # to a staggered velocity is the streamed loop's closing kick, opening
    # kick and drift, with the same roundings.
    gen = torch.Generator().manual_seed(15)
    pos, vel, f_old, f = (torch.randn((64, 3), generator=gen)
                          for _ in range(4))
    dt = 1e-3
    half = 0.5 * dt
    vh = vel + half * f_old  # a staggered velocity of the streamed loop
    v_full = vh + half * f  # its closing kick ...
    want_v = v_full + half * f  # ... and the next opening kick
    want_p = pos + dt * want_v
    p, v = pos.clone(), vh.clone()
    cycle = ((half, half, dt),) * 3
    rs._integrate_plain(p, v, f, False, dt, cycle[0])
    assert torch.equal(v, want_v) and torch.equal(p, want_p)


# -------------------------------------------------------- validation

def test_validation():
    pos = torch.zeros((rs.RESIDENT_SYM_MAX_N + 1, 3))
    with pytest.raises(ValueError, match="RESIDENT_SYM_MAX_N"):
        rs.simulate_resident_sym(pos, pos, steps=1, dt=DT)
    pos = torch.zeros((8, 3))
    with pytest.raises(ValueError, match="steps"):
        rs.simulate_resident_sym(pos, pos, steps=0, dt=DT)
    for fn in (rs.simulate_resident_sym_leapfrog,
               rs.simulate_resident_sym_yoshida4):
        with pytest.raises(ValueError, match="steps"):
            fn(pos, pos, steps=0, dt=DT)
    with pytest.raises(ValueError, match="coincident"):
        rs.simulate_resident_sym(pos, pos, steps=1, dt=DT, coincident="no")
    big = torch.zeros((64, 131072, 3))
    with pytest.raises(ValueError, match="admissible"):
        rs.simulate_resident_sym_ensemble(big, big, steps=2, dt=DT)
    with pytest.raises(ValueError, match="B\\*Np"):
        rs.simulate_resident_sym_ensemble(big, big, steps=2, dt=DT,
                                          tile=128)
    with pytest.raises(ValueError, match="steps"):
        rs.simulate_resident_sym_ensemble(big[:1, :8], big[:1, :8], steps=0,
                                          dt=DT)


@pytest.mark.parametrize("kw", [dict(resident=True, backend="direct"),
                                dict(resident=True, backend="mxu"),
                                dict(resident=True, integrator="rk4"),
                                dict(resident=True, split_w=True),
                                dict(resident_tile=256),
                                dict(resident_tile=32)])
def test_config_validation(kw):
    with pytest.raises(ValueError, match="resident"):
        SimConfig(n=64, **kw)


def test_config_accepts_the_resident_fields():
    cfg = SimConfig(n=64, resident=True, backend="sym_mxu", resident_tile=64)
    assert cfg.resident and cfg.resident_tile == 64
    SimConfig(n=64, resident=True, integrator="yoshida4")


@pytest.mark.parametrize("resident,tile", [(True, 64), (True, 128),
                                           (False, None), (None, 128)])
def test_from_dict_carries_the_resident_fields(resident, tile):
    jcfg = JSimConfig(n=300, backend="sym_mxu", resident=resident,
                      resident_tile=tile, interpret=True)
    cfg = SimConfig.from_dict(dataclasses.asdict(jcfg))
    assert cfg.resident is resident and cfg.resident_tile == tile
