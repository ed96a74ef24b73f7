"""B15's schedule on the CPU (its plain version): whole leapfrog and
Yoshida-4 runs in one schedule, with the opening pass (half-kick, drift)
and the closing pass (half-kick, no drift) inside it, and the last piece
of every pass summed by the integrating body itself.

Against the JAX package's resident leapfrog and Yoshida-4 drivers on the
same numpy inputs (interpret mode), single systems and ensembles, at
tiles 64 and 128, within the bound the JAX package holds its resident
kernel to against the streamed loop (rtol 1e-4, atol 1e-5 of the scale,
tests/test_resident_sym.py:21-48; on the CPU both classes multiply in
fp32); against the port's own streamed loop within the same bound; the
fused last-piece sum bitwise the separate slot-order reduce into a zeroed
accumulator, with -0 velocities and blocks that are no target of the last
piece; and the resident_sym_info binding's argument list."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import resident_sym as jr
from mini_nbody_tpu_torch import (BodyState, SimConfig, _build, simulate,
                                  simulate_ensemble)
from mini_nbody_tpu_torch.ops import resident_sym as rs
from mini_nbody_tpu_torch.ops import slot_pipe

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
DT = 1e-3


def _state(n, seed, b=None, masses=True):
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


def _counted(monkeypatch):
    """resident_plain counted: the `ends` of each call."""
    calls = []
    plain = rs.resident_plain

    def counted(*a, **k):
        calls.append(k.get("ends"))
        return plain(*a, **k)

    monkeypatch.setattr(rs, "resident_plain", counted)
    return calls


JAX = {("leapfrog", False): jr.simulate_resident_sym_leapfrog,
       ("yoshida4", False): jr.simulate_resident_sym_yoshida4,
       ("leapfrog", True): jr.simulate_resident_sym_ensemble_leapfrog,
       ("yoshida4", True): jr.simulate_resident_sym_ensemble_yoshida4}
PORT = {"leapfrog": rs.simulate_resident_sym_leapfrog,
        "yoshida4": rs.simulate_resident_sym_yoshida4}


@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4"])
@pytest.mark.parametrize("ensemble", [False, True])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("mxu", [False, True])
def test_kdk_in_one_schedule_vs_jax(monkeypatch, integrator, ensemble, tile,
                                    mxu):
    # N = 200: 4 blocks at tile 64 (56 pads), 2 at tile 128; 2 steps.
    pos, vel, mass = _state(200, 20, b=2 if ensemble else None)
    kw = dict(steps=2, dt=DT, softening=1e-2, mxu=mxu, tile=tile)
    want = JAX[integrator, ensemble](_j(pos), _j(vel), _j(mass),
                                     interpret=True, **kw)
    calls = _counted(monkeypatch)
    got = PORT[integrator](_t(pos), _t(vel), _t(mass), **kw)
    # One schedule, its end passes inside: the cycle's half-kick and drift.
    h1 = DT if integrator == "leapfrog" else rs.y4_cycle(DT)[1]
    assert calls == [(0.5 * h1, h1)]
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4"])
@pytest.mark.parametrize("backend", ["auto", "sym_mxu"])
def test_kdk_in_one_schedule_vs_the_streamed_loop(monkeypatch, integrator,
                                                  backend, steps):
    # simulate and simulate_ensemble with resident=True run one schedule
    # (no streamed force pass) and land within the class bound of the
    # streamed loop, also for one step (a leapfrog schedule of the two end
    # passes and no interior substep).
    n, b = 192, 2
    pos, vel, mass = _state(n, 21, b=b)
    cfg = SimConfig(n=n, dt=DT, steps=steps, softening=1e-2,
                    use_masses=True, integrator=integrator, backend=backend,
                    sym_tile=64, resident_tile=64)
    streamed = []
    for name in ("body_force_symmetric", "body_force_symmetric_ensemble"):
        monkeypatch.setattr(f"mini_nbody_tpu_torch.ops.symmetric_force."
                            f"{name}", lambda *a, **k: streamed.append(1))
    for name in ("body_force_sym_mxu", "body_force_sym_mxu_ensemble"):
        monkeypatch.setattr(f"mini_nbody_tpu_torch.ops.sym_mxu_force."
                            f"{name}", lambda *a, **k: streamed.append(1))
    calls = _counted(monkeypatch)
    one = BodyState(_t(pos[0]), _t(vel[0]), _t(mass[0]))
    ens = BodyState(_t(pos), _t(vel), _t(mass))
    res = simulate(cfg.replace(resident=True), one)
    res_ens = simulate_ensemble(cfg.replace(resident=True), ens)
    assert len(calls) == 2 and None not in calls and not streamed
    monkeypatch.undo()
    ref = simulate(cfg.replace(resident=False), one)
    ref_ens = simulate_ensemble(cfg.replace(resident=False), ens)
    for got, want in ((res, ref), (res_ens, ref_ens)):
        _close(got.pos, want.pos)
        _close(got.vel, want.vel)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("ends", [False, True])
def test_fused_last_piece_is_the_separate_reduce(monkeypatch, mxu, ends):
    # Pieces of 3 slots (4 blocks at tile 64: 8 slots, 3 pieces, the last
    # of 2 slots, so some blocks are no target of it). System 0 has no
    # mass at all, so every force is a signed zero, and -0 velocities: the
    # accumulator's 0 + sum turns them into +0. The fused schedule must be
    # bitwise the separate slot-order reduce into a zeroed accumulator.
    monkeypatch.setattr(slot_pipe, "PIECE_SLOTS", 3)
    n, tile = 200, 64
    pos, vel, mass = _state(n, 23, b=2)
    mass[0] = 0.0
    vel[0, :50] = -0.0
    slots = slot_pipe.slot_table(4, True, False, "cpu")
    pieces, _, _, last_target, _ = rs.resident_plan(slots)
    assert pieces.shape[0] == 3 and (last_target < 0).any()

    def padded():
        p = torch.cat([_t(pos), torch.full((2, 56, 3), 1.0e18)], dim=1)
        v = torch.cat([_t(vel), torch.zeros((2, 56, 3))], dim=1)
        m = torch.cat([_t(mass), torch.zeros((2, 56))], dim=1)
        return p, v, m

    cycle = ((0.5 * DT, 0.5 * DT, DT),) * 3
    kw = dict(y4=cycle, ends=(0.5 * DT, DT)) if ends else {}
    fused = padded()
    rs.resident_plain(*fused, slots, tile, n, 3, DT, 1e-2, mxu, True, **kw)

    def separate(part, plan, acc, tile_, width):
        acc = acc.clone()
        slot_pipe.slot_reduce_plain(part.reshape(-1),
                                    slot_pipe.reduce_plan(slots, True)[-1],
                                    acc, acc, tile_, width)
        return acc

    monkeypatch.setattr(rs, "_last_piece_plain", separate)
    ref = padded()
    rs.resident_plain(*ref, slots, tile, n, 3, DT, 1e-2, mxu, True, **kw)
    for a, b in zip(fused[:2], ref[:2]):
        assert torch.equal(a, b)
        assert torch.equal(torch.signbit(a), torch.signbit(b))
    # The massless system's -0 velocities came out +0.
    v0 = fused[1][0, :50]
    assert torch.equal(v0, torch.zeros_like(v0))
    assert not torch.signbit(v0).any()


def test_pass_coefficients():
    # The passes of a schedule: Euler steps, a cycle's substeps from its
    # phase, and the opening and closing passes around them.
    cycle = ((1.0, 2.0, 3.0), (4.0, 5.0, 6.0), (7.0, 8.0, 9.0))
    assert rs._pass_coeffs(2, None, 0, None) == [None, None]
    assert rs._pass_coeffs(4, cycle, 1, None) == [
        cycle[1], cycle[2], cycle[0], cycle[1]]
    assert rs._pass_coeffs(0, cycle, 0, (0.5, 1.5)) == [
        (0.5, None, 1.5), (0.5, None, None)]
    assert rs._pass_coeffs(1, cycle, 0, (0.5, 1.5)) == [
        (0.5, None, 1.5), cycle[0], (0.5, None, None)]


def test_closing_pass_keeps_a_negative_zero_velocity():
    # The closing pass is a flag, not a zero drift or kick: x stays put
    # and v + h/2 F is the only add.
    pos = torch.tensor([[1.0, -2.0, 3.0]])
    vel = torch.tensor([[-0.0, 0.5, -0.0]])
    f = torch.tensor([[0.0, 1.0, -0.0]])
    p, v = pos.clone(), vel.clone()
    rs._integrate_plain(p, v, f, False, DT, (0.25, None, None))
    assert torch.equal(p, pos)
    assert torch.equal(v, vel + 0.25 * f)
    assert torch.signbit(v[0, 2])


def test_resident_sym_info_binding():
    # The C entry's parameters in order, and its ctypes signature.
    src = (_build.CSRC / "resident_sym.cu").read_text()
    m = re.search(r'extern "C" int resident_sym_info\(([^)]*)\)', src)
    params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert params == ["tile", "mxu", "k", "fast", "wide", "out"]
    argtypes, restype = _build.SIGNATURES["resident_sym_info"]
    assert argtypes == [ctypes.c_int] * 5 + [ctypes.c_void_p]
    assert restype is ctypes.c_int
