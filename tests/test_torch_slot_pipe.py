"""Port vs JAX package: slot lists, the compensated operand split, the
duplicate scan, and K2's plain raw sums (tri and cross mode) vs the Pallas
slot kernels in interpret mode.

Raw sums are held at rtol=0, atol=5e-6 of the sums' scale, the bound
tests/test_slot_pipe.py:81 uses for the same accumulation-order
difference: on the CPU both sides multiply in fp32 and visit the same
slots with the same masks, but sum in another order.

tests/conftest.py turns on jax_enable_x64, so every input is made as an
np.float32 array: the JAX side then runs in fp32 like the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import slot_pipe as jsp
from mini_nbody_tpu.ops import sym_mxu_force as jsm
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.utils import tracing

torch.set_num_threads(1)

ATOL = 5e-6


def _state(n, seed, masses):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return pos, m


def _packs(pos, m, n, np_):
    jp, jpt, jv = jsm._pack(jnp.asarray(pos),
                            None if m is None else jnp.asarray(m), n, np_)
    tp, tv = sm._pack(torch.from_numpy(pos),
                      None if m is None else torch.from_numpy(m), n, np_)
    return (jp, jpt, jv), (tp, tv)


def _close_raw(got, want, cols=None):
    got, want = np.asarray(got), np.asarray(want)
    if cols is not None:
        got, want = got[:, :cols], want[:, :cols]
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale)


@pytest.mark.parametrize("nb", range(1, 10))
@pytest.mark.parametrize("fold", [False, True])
def test_tri_slot_list_equals_jax(nb, fold):
    assert sp.tri_slot_list(nb, fold) == jsp.tri_slot_list(nb, fold)
    assert sp.n_slots_tri(nb, fold) == jsp.n_slots_tri(nb, fold)
    table = sp.slot_table(nb, fold, False, "cpu")
    assert table.dtype == torch.int32
    assert table.tolist() == [list(r) for r in jsp.tri_slot_list(nb, fold)]


@pytest.mark.parametrize("nb", [1, 2, 5])
def test_cross_slot_list_equals_jax(nb):
    assert sp.cross_slot_list(nb) == jsp.cross_slot_list(nb)
    assert sp.slot_table(nb, True, True, "cpu").tolist() == [
        list(r) for r in jsp.cross_slot_list(nb)]
    assert (sp.SLOT_DIAG, sp.SLOT_CROSS, sp.SLOT_FOLD) == (
        jsp.SLOT_DIAG, jsp.SLOT_CROSS, jsp.SLOT_FOLD)


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("n,np_", [(256, 256), (300, 384)])
def test_pack_bitwise_equals_jax(masses, n, np_):
    pos, m = _state(n, 1, masses)
    (jp, _, jv), (tp, tv) = _packs(pos, m, n, np_)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    vhi = tv[:, :4].numpy()
    np.testing.assert_array_equal(
        vhi, torch.from_numpy(vhi).to(torch.bfloat16).float().numpy())


def _coincident_cases():
    rng = np.random.default_rng(9)
    base = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    dup = base.copy()
    dup[40] = dup[3]
    negzero = base.copy()
    negzero[10] = [0.0, 0.5, 0.25]
    negzero[20] = [-0.0, 0.5, 0.25]
    tiny = base.copy()
    tiny[7, 1] = 1e-20  # in (0, 2^-48)
    far = base.copy()
    far[5, 2] = 1.0e18
    ulp = base.copy()
    ulp[30] = np.nextafter(ulp[31], np.float32(2.0))  # distinct, close
    return {"distinct": base, "duplicate": dup, "negzero": negzero,
            "tiny": tiny, "far": far, "one_ulp_apart": ulp}


@pytest.mark.parametrize("case", list(_coincident_cases()))
def test_any_coincident_matches_jax(case):
    pos = _coincident_cases()[case]
    want = bool(jsm.any_coincident(jnp.asarray(pos)))
    assert sm.any_coincident(torch.from_numpy(pos)) == want
    assert want == (case not in ("distinct", "one_ulp_apart"))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_tri_raw_sums_vs_pallas(fold, mask, masses):
    pos, m = _state(256, 7, masses)
    if mask:  # the maskless kernel needs distinct bodies
        pos[65] = pos[70]  # within-block duplicate (fold territory)
        pos[130] = pos[3]  # cross-block duplicate
    (jp, jpt, jv), (tp, tv) = _packs(pos, m, 256, 256)
    want = jsp.build_tri_slot_call(1e-9, 64, 256, interpret=True,
                                   mask_offdiag=mask, fold=fold)(jp, jpt, jv)
    got = sp.build_tri_slot_call(1e-9, 64, 256, mask_offdiag=mask,
                                 fold=fold)(tp, tv)
    assert tuple(got.shape) == (8, 256)
    _close_raw(got, want)


@pytest.mark.parametrize("fold", [False, True])
def test_tri_raw_sums_ragged_tail(fold):
    # 200 real bodies + 56 FAR pads: pad-pad products stay finite and land
    # only in pad columns; the real columns match.
    pos, _ = _state(200, 4, False)
    (jp, jpt, jv), (tp, tv) = _packs(pos, None, 200, 256)
    want = jsp.build_tri_slot_call(1e-9, 64, 256, interpret=True,
                                   mask_offdiag=False, fold=fold)(jp, jpt, jv)
    got = sp.build_tri_slot_call(1e-9, 64, 256, mask_offdiag=False,
                                 fold=fold)(tp, tv)
    assert torch.isfinite(got).all()
    _close_raw(got, want, cols=200)


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_cross_raw_sums_vs_pallas(mask, masses):
    pos, m = _state(256, 13, masses)
    (jp, jpt, jv), (tp, tv) = _packs(pos, m, 256, 256)
    want = jsp.build_cross_slot_call(1e-9, 64, 128, interpret=True,
                                     mask=mask)(
        jp[:128], jpt[:, 128:], jv[:128], jv[128:])
    got = sp.build_cross_slot_call(1e-9, 64, 128, mask=mask)(
        tp[:128], tp[128:], tv[:128], tv[128:])
    for g, w in zip(got, want):
        assert tuple(g.shape) == (8, 128)
        _close_raw(g, w)


def test_split_w_raw_sums_vs_pallas():
    pos, m = _state(256, 17, True)
    (jp, jpt, jv), (tp, tv) = _packs(pos, m, 256, 256)
    want = jsp.build_tri_slot_call(1e-9, 64, 256, interpret=True,
                                   split_w=True)(jp, jpt, jv)
    got = sp.build_tri_slot_call(1e-9, 64, 256, split_w=True)(tp, tv)
    _close_raw(got, want)


def test_plain_bf16_mode_rounds_like_tensor_cores():
    # bf16 mode vs fp32 mode differ by the bf16 rounding of w (~2^-9
    # relative per pair), and split_w restores the fp32 class.
    pos, m = _state(256, 19, True)
    _, (tp, tv) = _packs(pos, m, 256, 256)
    f32 = sp.tri_slot_sums_plain(tp, tv, 1e-9, 64)
    b16 = sp.tri_slot_sums_plain(tp, tv, 1e-9, 64, mma_dtype=torch.bfloat16)
    split = sp.tri_slot_sums_plain(tp, tv, 1e-9, 64, split_w=True,
                                   mma_dtype=torch.bfloat16)
    scale = f32.abs().max()
    err_b16 = (b16 - f32).abs().max() / scale
    err_split = (split - f32).abs().max() / scale
    assert 1e-6 < err_b16 < 1e-2
    assert err_split < err_b16 / 10


def test_wrappers_take_plain_on_cpu_and_check_inputs():
    pos, _ = _state(256, 21, False)
    _, (tp, tv) = _packs(pos, None, 256, 256)
    before = tracing.counters()
    got = sp.build_tri_slot_call(1e-9, 64, 256)(tp, tv)
    moved = tracing.counters() - before
    assert not [k for k in moved if k.startswith("launch.")]
    assert torch.equal(got, sp.tri_slot_sums_plain(tp, tv, 1e-9, 64))
    acc = torch.zeros(256, 8)
    slots = sp.slot_table(4, True, False, "cpu")
    with pytest.raises(ValueError):
        sp.tri_slot_sums_(acc, tp, tv, slots, 96, 1e-9)  # 256 % 96 != 0
    with pytest.raises(TypeError):
        sp.tri_slot_sums_(acc, tp.double(), tv, slots, 64, 1e-9)
    with pytest.raises(TypeError):
        sp.tri_slot_sums_(acc, tp, tv, slots.long(), 64, 1e-9)
    with pytest.raises(ValueError):
        sp.tri_slot_sums_(acc[:128], tp, tv, slots, 64, 1e-9)


def test_system_groups_cap_at_the_grid_limit(monkeypatch):
    # One-slot systems: a launch takes every system up to gridDim.y's
    # 65,535; a piece of PIECE_SLOTS slots takes one system per launch.
    assert sp.system_groups(70000, 1) == [(0, 65535), (65535, 4465)]
    assert sp.system_groups(3, 1) == [(0, 3)]
    assert sp.system_groups(3, sp.PIECE_SLOTS) == [(0, 1), (1, 1), (2, 1)]
    monkeypatch.setattr(sp, "PIECE_SLOTS", 20)
    assert sp.system_groups(5, 8) == [(0, 2), (2, 2), (4, 1)]


@pytest.mark.parametrize("nb,cross,piece", [(5, False, 1 << 16),
                                             (5, False, 4), (4, True, 3)])
def test_slot_reduce_adds_each_blocks_partials_in_slot_order(
        monkeypatch, nb, cross, piece):
    # The plan against a walk of the slot list itself: slot s adds partial
    # tile 2 s into block bi and, unless it is DIAG, tile 2 s + 1 into block
    # bj (of the second accumulator in cross mode), in slot order, bitwise.
    monkeypatch.setattr(sp, "PIECE_SLOTS", piece)
    tile, width, n_sys = 4, 3, 2
    slots = sp.slot_table(nb, True, cross, "cpu")
    rows = slots.numpy()
    part = torch.from_numpy(np.random.default_rng(30).normal(
        size=(n_sys * rows.shape[0] * 2, tile, width)).astype(np.float32))
    got = [torch.zeros((n_sys * nb * tile, width)) for _ in range(2)]
    want = [torch.zeros((n_sys, nb, tile, width)) for _ in range(2)]
    for piece_plan in sp.reduce_plan(slots, not cross):
        s0, n = piece_plan[:2]
        tiles = part.view(n_sys, -1, tile, width)[:, 2 * s0:2 * (s0 + n)]
        sp.slot_reduce_(tiles.contiguous().view(-1), piece_plan, got[0],
                        got[1] if cross else got[0], tile, width, n_sys,
                        nb * tile)
        for s in range(n_sys):
            sums = {}
            for local, (kind, bi, bj) in enumerate(rows[s0:s0 + n]):
                sides = [(0, bi, 2 * local)]
                if kind != sp.SLOT_DIAG:
                    sides.append((int(cross), bj, 2 * local + 1))
                for acc, blk, e in sides:
                    key = (acc, blk)
                    sums[key] = sums.get(key, 0) + tiles[s, e]
            for (acc, blk), total in sums.items():
                want[acc][s, blk] += total
    for g, w in zip(got, want):
        assert torch.equal(g, w.view(-1, width))
