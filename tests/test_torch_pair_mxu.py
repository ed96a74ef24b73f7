"""Port vs JAX package: body_force_pair_mxu (B4, K2's cross mode over a
rectangle; its plain version on the CPU) against JAX's body_force_pair_mxu in
interpret mode (tile=64), the coincident modes, and the rectangle in the K2
wrappers.

Tolerances: forces at rtol 1e-3, atol 1e-4 of max|F| (K1's bound): both
sides multiply in fp32 on the CPU (JAX's interpret run; K2's plain version
with mma_dtype float32) and sum in other orders; against the fp64 oracle at
JAX's interpret bound for the sym_mxu class (rtol 1e-4, atol 1e-5 of the
scale, tests/test_slot_pipe.py:24). auto and fast against masked on
duplicate-free sets: bitwise (the plain path has no atomics). Inputs are
np.float32, since conftest.py turns on jax_enable_x64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import sym_mxu_force as jsm
from mini_nbody_tpu_torch.ops import mxu_force as mf
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4
RTOL_REF, ATOL_REF = 1e-4, 1e-5


def _sets(na, nb, seed, masses, shift=0.5):
    rng = np.random.default_rng(seed)
    pa = rng.uniform(-1, 1, (na, 3)).astype(np.float32)
    pb = (rng.uniform(-1, 1, (nb, 3)) + shift).astype(np.float32)
    ma = rng.uniform(0.5, 2.0, na).astype(np.float32) if masses else None
    mb = rng.uniform(0.5, 2.0, nb).astype(np.float32) if masses else None
    return pa, pb, ma, mb


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _port(pa, pb, ma, mb, **kw):
    fa, fb = sm.body_force_pair_mxu(_t(pa), _t(pb), _t(ma), _t(mb), **kw)
    assert fa.shape == (pa.shape[0], 3) and fb.shape == (pb.shape[0], 3)
    assert fa.dtype == fb.dtype == torch.float32
    return fa.numpy(), fb.numpy()


@pytest.mark.parametrize("coincident", ["masked", "fast", "auto"])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("na,nb", [(70, 130), (200, 37), (129, 64)])
def test_pair_mxu_vs_jax(na, nb, masses, coincident, oracle_rect):
    pa, pb, ma, mb = _sets(na, nb, na + nb, masses)
    ja, jb = jsm.body_force_pair_mxu(_j(pa), _j(pb), _j(ma), _j(mb),
                                     softening=1e-2, tile=64, interpret=True,
                                     coincident=coincident)
    fa, fb = _port(pa, pb, ma, mb, softening=1e-2, tile=64,
                   coincident=coincident)
    _close(fa, np.asarray(ja))
    _close(fb, np.asarray(jb))
    _close(fa, oracle_rect(pa, pb, mb, softening=1e-2), RTOL_REF, ATOL_REF)
    _close(fb, oracle_rect(pb, pa, ma, softening=1e-2), RTOL_REF, ATOL_REF)


@pytest.mark.parametrize("masses", [False, True])
def test_pair_mxu_matches_the_mxu_rectangles(masses):
    # F_on_a is the rectangular B6 call a <- b, F_on_b the reverse (bf16
    # class, fp32 products on the CPU).
    pa, pb, ma, mb = _sets(150, 90, 3, masses)
    fa, fb = _port(pa, pb, ma, mb, softening=1e-2, tile=64)
    _close(fa, mf.body_force_mxu(_t(pa), _t(pb), _t(mb), 1e-2).numpy())
    _close(fb, mf.body_force_mxu(_t(pb), _t(pa), _t(ma), 1e-2).numpy())


@pytest.mark.parametrize("coincident", ["fast", "auto"])
def test_fast_and_auto_bitwise_equal_masked(coincident):
    pa, pb, ma, mb = _sets(300, 200, 4, True)
    want = _port(pa, pb, ma, mb, tile=64, coincident="masked")
    got = _port(pa, pb, ma, mb, tile=64, coincident=coincident)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dup", [False, True])
def test_auto_above_the_gate(dup, monkeypatch):
    # na + nb = K2's gate, set to 8192: 'auto' scans the concatenated sets;
    # a cross-set duplicate routes to masked, and either way the result is
    # bitwise the masked one.
    monkeypatch.setattr(sm, "COINCIDENT_AUTO_MIN_N", 8192)
    na = 8192 // 2
    pa, pb, _, _ = _sets(na, na, 5, False, shift=0.0)
    if dup:
        pb[7] = pa[3]
    assert sm.any_coincident(torch.cat([_t(pa), _t(pb)])) == dup
    want = _port(pa, pb, None, None, tile=128, coincident="masked")
    got = _port(pa, pb, None, None, tile=128, coincident="auto")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.isfinite(g).all()


def test_cross_set_duplicate_is_inert_when_masked(oracle_rect):
    pa, pb, ma, mb = _sets(100, 80, 6, True, shift=0.0)
    pb[10] = pa[20]
    fa, fb = _port(pa, pb, ma, mb, softening=1e-9, tile=64)
    ja, jb = jsm.body_force_pair_mxu(_j(pa), _j(pb), _j(ma), _j(mb),
                                     tile=64, interpret=True)
    _close(fa, np.asarray(ja))
    _close(fb, np.asarray(jb))
    _close(fa, oracle_rect(pa, pb, mb), RTOL, ATOL)


def test_a_single_mass_raises():
    pa, pb, ma, mb = _sets(20, 30, 7, True)
    for a, b in ((ma, None), (None, mb)):
        with pytest.raises(ValueError, match="both masses or neither"):
            sm.body_force_pair_mxu(_t(pa), _t(pb), _t(a), _t(b))
        with pytest.raises(ValueError, match="both masses or neither"):
            jsm.body_force_pair_mxu(_j(pa), _j(pb), _j(a), _j(b),
                                    interpret=True)
    with pytest.raises(ValueError, match="coincident"):
        sm.body_force_pair_mxu(_t(pa), _t(pb), coincident="no")


@pytest.mark.parametrize("na,nb,tile", [(70, 130, 64), (129, 64, 128)])
def test_tile_resolution(monkeypatch, na, nb, tile):
    # The plain path shrinks the tile as JAX's interpret mode does (the card
    # path keeps K2's tile and pads both sets to it).
    seen = []
    real = sp.pair_slot_sums_

    def spy(acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, t, *args):
        seen.append((pos_a.shape[0], pos_b.shape[0], t, slots.shape[0]))
        return real(acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, t, *args)

    monkeypatch.setattr(sp, "pair_slot_sums_", spy)
    pa, pb, _, _ = _sets(na, nb, 8, False)
    sm.body_force_pair_mxu(_t(pa), _t(pb), tile=tile)
    t = min(tile, sm.round_up(na, 8), sm.round_up(nb, 8))
    ra, rb = sm.round_up(na, t), sm.round_up(nb, t)
    assert seen == [(ra, rb, t, (ra // t) * (rb // t))]


def test_rectangle_slot_table_and_plain_sums():
    # K2's cross mode over an na x nb block rectangle: every (i, j) once,
    # i-major, and the plain sums of two sets of different lengths against
    # JAX's _pair_call raw sums.
    slots = sp.slot_table(2, False, True, "cpu", nb_b=3).numpy()
    assert slots.tolist() == [[sp.SLOT_CROSS, i, j] for i in range(2)
                              for j in range(3)]
    pa, pb, ma, mb = _sets(128, 192, 9, True)
    a, va = sm._pack(_t(pa), _t(ma), 128, 128)
    b, vb = sm._pack(_t(pb), _t(mb), 192, 192)
    rows, cols = sp.cross_slot_sums_plain(a, b, va, vb, 1e-2, 64)
    assert rows.shape == (8, 128) and cols.shape == (8, 192)
    ja, jb = jsm.body_force_pair_mxu(_j(pa), _j(pb), _j(ma), _j(mb),
                                     softening=1e-2, tile=64, interpret=True)
    _close(sm._combine(a, rows.T).numpy(), np.asarray(ja))
    _close(sm._combine(b, cols.T).numpy(), np.asarray(jb))


def test_k2_wrapper_checks_each_side_by_its_own_length():
    tile = 64
    pa, va = sm._pack(_t(_sets(64, 1, 10, False)[0]), None, 64, 64)
    pb, vb = sm._pack(_t(_sets(128, 1, 11, False)[0]), None, 128, 128)
    slots = sp.slot_table(1, False, True, "cpu", nb_b=2)
    acc_a, acc_b = torch.zeros(64, 8), torch.zeros(128, 8)
    sp.pair_slot_sums_(acc_a, acc_b, pa, pb, va, vb, slots, tile, 1e-2)
    assert torch.isfinite(acc_a).all() and acc_b.abs().sum() > 0
    with pytest.raises(ValueError, match="acc_b"):
        sp.pair_slot_sums_(acc_a, torch.zeros(64, 8), pa, pb, va, vb, slots,
                           tile, 1e-2)
    with pytest.raises(ValueError, match="multiple of tile"):
        sp.pair_slot_sums_(acc_a, acc_b[:100], pa, pb[:100], va, vb[:100],
                           slots, tile, 1e-2)
    with pytest.raises(ValueError, match="tri mode"):
        sp._launch(False, acc_a, acc_b, pa, pb, va, vb, slots, tile, 1e-2,
                   False, True)
