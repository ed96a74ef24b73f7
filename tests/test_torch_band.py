"""Port vs JAX package: the band traversal of sym_mxu (B16's plain path on
the CPU) against the JAX band kernels in interpret mode: body_force_sym_mxu
and body_force_sym_mxu_ensemble with traversal='band', and simulate on it.

Tolerances. Forces against JAX's band: rtol 0, atol 5e-6 of the force scale,
the bound of tests/test_torch_sym_mxu.py (on the CPU both sides multiply in
fp32 and differ only in the order of the sums), and against body_force_jnp
at the interpret-mode bound of tests/test_sym_mxu.py (rtol 1e-4, atol 1e-5
of the scale). The port's band against the port's slots: 5e-6 of the scale
(tests/test_slot_pipe.py:75). simulate: rtol 1e-4, atol 1e-5 of the scale
(tests/test_torch_trajectory.py). The plain version's bf16 mode (what the
card holds B16 to) against the fp64 plain force: the on-card bf16-accumulate
bound, rtol 2e-2, atol 5e-3 of the scale. The port against itself: each
ensemble system bitwise its standalone band call, 'fast' and 'auto' bitwise
'masked'. Inputs are np.float32 arrays, since tests/conftest.py turns on
jax_enable_x64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu import sim as jsim
from mini_nbody_tpu.models import init as jinit
from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.ops import sym_mxu_force as jsm
from mini_nbody_tpu.ops.reference import body_force_jnp
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import BodyState, SimConfig, simulate
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.ops.reference import body_force_torch

torch.set_num_threads(1)

ATOL = 5e-6
RTOL_REF, ATOL_REF = 1e-4, 1e-5
RTOL_TRAJ, ATOL_TRAJ = 1e-4, 1e-5
RTOL_BF16, ATOL_BF16 = 2e-2, 5e-3


def _state(n, seed, masses):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return pos, m


def _plummer(n, seed):
    s = jinit.plummer(jax.random.key(seed), n)
    return tuple(np.array(a, np.float32) for a in (s.pos, s.vel, s.mass))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _scale(a):
    return max(float(np.abs(a).max()), 1.0)


def _band(pos, m, softening=1e-9, **kw):
    """(JAX's band in interpret mode, the port's band) on the same input."""
    j = np.asarray(jsm.body_force_sym_mxu(
        _j(pos), _j(m), softening=softening, interpret=True,
        traversal="band", **kw))
    t = sm.body_force_sym_mxu(_t(pos), _t(m), softening=softening,
                              traversal="band", **kw).numpy()
    return j, t


@pytest.mark.parametrize("n,tile,chunk,masses", [
    (256, 64, 256, False),
    (300, 64, 128, True),      # multi-chunk, ragged tail: cross calls
    (512, 64, 512, False),     # even block count: the half-active wrap band
    (200, 64, 64, False),      # many chunks
])
def test_band_vs_jax(n, tile, chunk, masses):
    pos, m = _state(n, n, masses)
    j, t = _band(pos, m, softening=1e-2, tile=tile, chunk=chunk)
    assert t.shape == (n, 3) and t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL * _scale(j))
    ref = np.asarray(body_force_jnp(_j(pos), _j(pos), _j(m),
                                    softening=1e-2))
    np.testing.assert_allclose(t, ref, rtol=RTOL_REF,
                               atol=ATOL_REF * _scale(ref))


@pytest.mark.parametrize("chunk", [256, 128])
def test_band_plummer_masses_vs_jax(chunk):
    pos, _, m = _plummer(256, 11)
    j, t = _band(pos, m, softening=1e-2, tile=64, chunk=chunk)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL * _scale(j))


@pytest.mark.parametrize("coincident", ["masked", "fast"])
def test_band_default_softening_vs_jax(coincident):
    # Softening 1e-9: only the self-pair mask of the diagonal blocks keeps
    # the eps^-1.5 weights out of the sums.
    pos, _ = _state(384, 5, False)
    j, t = _band(pos, None, tile=64, chunk=128, coincident=coincident)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL * _scale(j))


def test_band_split_w_vs_jax():
    pos, m = _state(256, 8, True)
    j, t = _band(pos, m, softening=1e-2, tile=64, chunk=128, split_w=True)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL * _scale(j))


@pytest.mark.parametrize("n,tile", [(192, 64), (300, 64), (128, 128)])
def test_band_ensemble_vs_jax_and_bitwise_standalone(n, tile):
    # nb = 3 (odd), 5 (odd, ragged tail), 1 (one diagonal block), as
    # tests/test_ensemble.py:54-75.
    systems = [_plummer(n, 7 * i + 1) for i in range(3)]
    pos = np.stack([s[0] for s in systems])
    mass = np.stack([s[2] for s in systems])
    want = np.asarray(jsm.body_force_sym_mxu_ensemble(
        _j(pos), _j(mass), softening=1e-2, tile=tile, interpret=True,
        traversal="band"))
    got = sm.body_force_sym_mxu_ensemble(_t(pos), _t(mass), softening=1e-2,
                                         tile=tile, traversal="band")
    assert got.shape == (3, n, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATOL * _scale(want))
    t, c = sm.ensemble_tiling(n, tile, kernel=False)
    for i in range(3):
        alone = sm.body_force_sym_mxu(_t(pos[i]), _t(mass[i]),
                                      softening=1e-2, tile=t, chunk=c,
                                      traversal="band")
        assert torch.equal(got[i], alone), i


@pytest.mark.parametrize("dups", [False, True])
def test_band_fast_auto_bitwise_masked(dups, monkeypatch):
    # B16's own gate at N: 'auto' runs the duplicate scan and routes to the
    # maskless (no duplicates) or masked (duplicates) walk; either way the
    # result is bitwise the masked one, and 'fast' is too without
    # duplicates.
    n = 384
    monkeypatch.setattr(sm, "BAND_COINCIDENT_AUTO_MIN_N", n)
    pos, _ = _state(n, 4, False)
    if dups:
        pos[300] = pos[5]
    p = torch.from_numpy(pos)
    masked = sm.body_force_sym_mxu(p, tile=64, chunk=128,
                                   coincident="masked", traversal="band")
    auto = sm.body_force_sym_mxu(p, tile=64, chunk=128, coincident="auto",
                                 traversal="band")
    assert torch.equal(auto, masked) and torch.isfinite(auto).all()
    if not dups:
        fast = sm.body_force_sym_mxu(p, tile=64, chunk=128,
                                     coincident="fast", traversal="band")
        assert torch.equal(fast, masked)


def test_band_gate_is_its_own(monkeypatch):
    # The band reads BAND_COINCIDENT_AUTO_MIN_N, the slots K2's gate.
    calls = []
    monkeypatch.setattr(sm, "any_coincident",
                        lambda p: calls.append(p.shape[0]) or False)
    p = torch.from_numpy(_state(128, 2, False)[0])
    monkeypatch.setattr(sm, "BAND_COINCIDENT_AUTO_MIN_N", 64)
    sm.body_force_sym_mxu(p, tile=64, traversal="band")
    sm.body_force_sym_mxu(p, tile=64, traversal="slots")
    assert calls == [128]


@pytest.mark.parametrize("n,tile,chunk", [(256, 64, 256), (384, 64, 128)])
def test_band_vs_slots_close(n, tile, chunk):
    # tests/test_slot_pipe.py:75 on its own state (plummer, key n, the
    # default softening); on Gaussian bodies at this softening JAX's own two
    # traversals differ by 1.1e-5 of the scale (accumulation order).
    p = torch.from_numpy(_plummer(n, n)[0])
    band = sm.body_force_sym_mxu(p, tile=tile, chunk=chunk,
                                 traversal="band").numpy()
    slots = sm.body_force_sym_mxu(p, tile=tile, chunk=chunk,
                                  traversal="slots").numpy()
    np.testing.assert_allclose(slots, band, rtol=0, atol=ATOL * _scale(band))


def test_simulate_band_vs_jax():
    n = 300
    pos, vel, mass = _plummer(n, 3)
    kw = dict(n=n, dt=1e-3, steps=5, softening=1e-2, integrator="leapfrog",
              use_masses=True, backend="sym_mxu", traversal="band",
              resident=False, sym_tile=64, sym_chunk=128)
    jout = jsim.simulate(JSimConfig(interpret=True, **kw),
                         JBodyState.create(pos, vel, mass))
    out = simulate(SimConfig(**kw),
                   BodyState.from_numpy(pos, vel, mass, device="cpu"))
    for got, want in ((out.pos, jout.pos), (out.vel, jout.vel)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_TRAJ,
                                   atol=ATOL_TRAJ * _scale(want))


def _plain_bf16_force(pos, m, tile, chunk, softening, split_w):
    """The band's raw sums through _band_sums_plain in bf16 mode, chunked
    as body_force_sym_mxu chunks them, then the epilogue."""
    n = pos.shape[0]
    tile, c, nc, np_ = sm._resolve_tiling(n, tile, chunk, kernel=False)
    p, v = sm._pack(pos, m, n, np_)
    rows, cols = torch.zeros((np_, 8)), torch.zeros((np_, 8))
    ch = [slice(a * c, (a + 1) * c) for a in range(nc)]
    pairs = [(a, a) for a in range(nc)] + [
        (a, b) for a in range(nc) for b in range(a + 1, nc)]
    for a, b in pairs:
        sm._band_sums_plain(rows[ch[a]], cols[ch[b]], p[ch[a]], p[ch[b]],
                            v[ch[a]], v[ch[b]], tile, softening, split_w,
                            True, a != b, mma_dtype=torch.bfloat16)
    return sm._combine(p, rows + cols)[:n]


@pytest.mark.parametrize("masses,split_w", [(False, False), (True, False),
                                            (True, True)])
def test_plain_bf16_mode_vs_fp64(masses, split_w):
    pos, m = _state(300, 21, masses)
    got = _plain_bf16_force(_t(pos), _t(m), 64, 128, 1e-2, split_w)
    want = body_force_torch(_t(pos).double(), _t(pos).double(),
                            None if m is None else _t(m).double(),
                            softening=1e-2).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_BF16,
                               atol=ATOL_BF16 * _scale(want))


@pytest.mark.parametrize("nb", range(1, 10))
def test_band_plan_covers_each_block_pair_once(nb):
    # Tri: the diagonal blocks plus the plan's off-diagonal tiles are every
    # unordered block pair exactly once (the even-nb wrap band half-active),
    # each column block's partials in increasing i.
    steps = sm.band_steps(nb, False)
    targets, offsets, entries = sm._band_plan_np(nb, False, 0, nb)
    seen = [frozenset((i,)) for i in range(nb)]
    for t, j in enumerate(targets // 2):
        e = entries[offsets[t]:offsets[t + 1]]
        i, d = e // steps, e % steps
        assert (d >= 1).all() and ((i + d) % nb == j).all()
        assert (np.diff(i) > 0).all()
        seen += [frozenset((int(a), int(j))) for a in i]
    assert sorted(seen, key=sorted) == sorted(
        {frozenset((a, b)) for a in range(nb) for b in range(nb)},
        key=sorted)
    # Cross: every (i, j), column block j's partials in increasing i.
    targets, offsets, entries = sm._band_plan_np(nb, True, 0, nb)
    assert (targets // 2 == np.arange(nb)).all()
    for t in range(nb):
        e = entries[offsets[t]:offsets[t + 1]]
        assert ((e % nb) == t).all() and (e // nb == np.arange(nb)).all()


@pytest.mark.parametrize("cap", [1, 5, 40, 1 << 20])
@pytest.mark.parametrize("nb,cross", [(1, False), (8, False), (9, False),
                                      (7, True)])
def test_band_pieces(nb, cross, cap, monkeypatch):
    # Ascending, contiguous, equal ranges (the last may be shorter) that
    # cover every row block, each within the cap unless one row exceeds it.
    monkeypatch.setattr(sm, "BAND_PIECE_TILES", cap)
    steps = sm.band_steps(nb, cross)
    pieces = sm.band_pieces(nb, cross)
    assert pieces[0][0] == 0 and pieces[-1][1] == nb
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    sizes = [i1 - i0 for i0, i1 in pieces]
    assert all(s == sizes[0] for s in sizes[:-1]) and sizes[-1] <= sizes[0]
    assert all(s * steps <= cap for s in sizes) or sizes == [1] * nb
    # A launch takes as many systems as fit under the cap.
    _, group, longest = sm.band_launches(nb, cross, 100)
    assert longest == sizes[0] * steps
    assert group == min(100, max(1, cap // longest))


def test_band_wrappers_check_their_operands():
    pos, m = _state(128, 1, True)
    p, v = sm._pack(_t(pos), _t(m), 128, 128)
    rows, cols = torch.zeros(128, 8), torch.zeros(128, 8)
    with pytest.raises(ValueError, match="multiple of tile"):
        sm.band_tri_sums_(rows[:96], cols[:96], p[:96], v[:96], 64, 1e-2)
    with pytest.raises(ValueError, match="shape"):
        sm.band_tri_sums_(rows[:64], cols, p, v, 64, 1e-2)
    with pytest.raises(TypeError, match="float32"):
        sm.band_tri_sums_(rows.double(), cols, p, v, 64, 1e-2)
    with pytest.raises(ValueError, match="systems"):
        sm.band_tri_sums_ensemble_(rows, cols, p, v, 64, 1e-2, 3)
    with pytest.raises(ValueError, match="traversal"):
        sm.body_force_sym_mxu(p, traversal="bands")
