"""The block schedule of the grid backward's pair VJP (B12) against the JAX
package on the CPU.

B12 (csrc/vjp_kernel.cu, vjp_pair_kernel) computes each ordered pair a <- b
once, on a cross slot table over a's row blocks and b's column blocks
(slot_pipe.slot_table with nb_b): each slot stores a_bar's (T, 3) row
partial and b_bar's (T, 3) column partial, and csrc/slot_reduce.cu adds
each block's partials in slot order. ``b12_schedule`` below is that
schedule in PyTorch: the wrapper's padding (vjp_kernel.pair_operands: FAR
pads, zero cotangent, zero mass), the kernel's per-pair terms (inv zeroed
where every |d_i| <= 2^-75, m_b folded into w and u, the 3 and g_a
applied per slot), the partial layout, and slot_reduce_plain in the plan's
order, over several pieces of slots. It is held to JAX's ``vjp_pos_pair``
(its Pallas kernel in interpret mode) with and without masses, on ragged
sets and on sets that share bodies, at rtol 1e-5 and atol 1e-6 of each
output's scale: both sides are fp32 and differ only in the grouping of the
sums.

That mask is the plain version's d2 == 0 (its squares rounded apart, then
added): the schedule is held to vjp_pos_pair_plain on pairs 1e-24, 2^-75
(masked: d2 underflows to 0), one float past 2^-75 and 1e-20 (not masked:
d2 is a denormal) apart.

The design rests on B11's CROSS term with g_b = 0 being B12's term: B11's
plain version (vjp_kernel.vjp_sym_sums_plain) over the same cross table
with zero column cotangents is held to JAX's vjp_pos_pair at the same
tolerance. And the reduce plan's launch order (slot_pipe.launch_order, the
order csrc/slot_reduce.cu starts its CTAs in) is a permutation of
plan_pieces' targets, longest list first, that leaves every list as it was.

Inputs are np.float32 arrays: tests/conftest.py turns on jax_enable_x64.
"""

import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import vjp_kernel as jv
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import vjp_kernel as vk
from mini_nbody_tpu_torch.ops.symmetric_force import _pack

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
#: The kernel's mask (csrc/vjp_kernel.cu kD2Zero): the plain version's
#: d2 == 0 holds iff every |d_i| <= 2^-75, whose square rounds to 0.
D2_ZERO = 2.0 ** -75


def _inputs(na, nb, masses, shared, seed=0):
    """pos_a, g_a (na, 3), pos_b (nb, 3) and both masses or None. shared:
    a's first half are b's last bodies (the row and column groups of a grid
    tile overlap), or "apart": three of a's bodies at other indices of b
    (coincident pairs off every tile's diagonal)."""
    rng = np.random.default_rng(seed + 11 * na + nb)
    pos_a = rng.uniform(-1, 1, (na, 3)).astype(np.float32)
    pos_b = rng.uniform(-1, 1, (nb, 3)).astype(np.float32)
    m_a = rng.uniform(0.5, 2.0, na).astype(np.float32)
    m_b = rng.uniform(0.5, 2.0, nb).astype(np.float32)
    if shared == "apart":
        for i, j in ((0, nb - 1), (na - 1, 0), (na // 2, nb // 3)):
            pos_b[j] = pos_a[i]
    elif shared:
        k = min(na, nb) // 2
        pos_b[nb - k:] = pos_a[:k]
        m_b[nb - k:] = m_a[:k]
    g_a = rng.normal(size=(na, 3)).astype(np.float32)
    if not masses:
        m_a = m_b = None
    return pos_a, g_a, pos_b, m_a, m_b


def _jax(pos_a, g_a, pos_b, m_a, m_b, softening):
    out = jv.vjp_pos_pair(pos_a, g_a, pos_b, m_a, m_b, softening=softening,
                          interpret=True)
    return [np.asarray(o) for o in out]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max(), err_msg=what)


def b12_schedule(pos_a, g_a, pos_b, m_b, softening, tile):
    """B12's block schedule in PyTorch: per piece of the cross slot table,
    every slot's (T, 3) row and column partials as the kernel forms them,
    then slot_reduce_plain in slot order. Returns (a_bar, b_bar)."""
    na, nb = pos_a.shape[0], pos_b.shape[0]
    pa, ga, pb = vk.pair_operands(pos_a, g_a, pos_b, m_b, tile)
    slots = sp.slot_table(pa.shape[0] // tile, False, True, "cpu",
                          nb_b=pb.shape[0] // tile)
    acc_a = torch.zeros((pa.shape[0], 3))
    acc_b = torch.zeros((pb.shape[0], 3))
    rows_a, cot_a = pa.view(-1, tile, 3), ga.view(-1, tile, 3)
    cols_b = pb.view(-1, tile, pb.shape[1])
    table = slots.long()
    for plan in sp.reduce_plan(slots, False):
        s0, n = plan[:2]
        bi, bj = table[s0:s0 + n, 1], table[s0:s0 + n, 2]
        p, g, q = rows_a[bi], cot_a[bi], cols_b[bj]
        d = [q[:, None, :, k] - p[:, :, None, k] for k in range(3)]
        inv = torch.rsqrt(d[0] * d[0] + d[1] * d[1]
                          + (d[2] * d[2] + softening))
        far = torch.stack([x.abs() for x in d]).amax(0)
        inv = torch.where(far <= D2_ZERO, torch.zeros_like(inv), inv)
        inv2 = inv * inv
        w = inv2 * inv  # w' = m_b w
        if q.shape[-1] == 4:
            w = w * q[:, None, :, 3]
        ud = (w * inv2) * sum(g[..., k:k + 1] * d[k] for k in range(3))
        rows = torch.stack([3.0 * (ud * d[k]).sum(2)
                            - g[..., k] * w.sum(2) for k in range(3)], -1)
        cols = torch.stack([(w * g[..., k:k + 1]).sum(1)
                            - 3.0 * (ud * d[k]).sum(1) for k in range(3)],
                           -1)
        part = torch.stack([rows, cols], 1).reshape(-1)
        sp.slot_reduce_plain(part, plan, acc_a, acc_b, tile, 3)
    return acc_a[:na], acc_b[:nb]


CASES = [(37, 53, False), (37, 53, True), (64, 40, "apart"), (5, 96, True),
         (1, 1, True)]


@pytest.mark.parametrize("softening", [1e-9, 1e-2])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("na,nb,shared", CASES)
@pytest.mark.parametrize("tile", [8, 16])
def test_b12_schedule_matches_jax(monkeypatch, na, nb, shared, masses,
                                  softening, tile):
    # Pieces of 5 slots: the lists cross pieces, as a 262,144^2 call's do.
    monkeypatch.setattr(sp, "PIECE_SLOTS", 5)
    pos_a, g_a, pos_b, m_a, m_b = _inputs(na, nb, masses, shared)
    want = _jax(pos_a, g_a, pos_b, m_a, m_b, softening)
    got = b12_schedule(_t(pos_a), _t(g_a), _t(pos_b), _t(m_b), softening,
                       tile)
    for g, w, side in zip(got, want, ("a_bar", "b_bar")):
        assert torch.isfinite(g).all()
        _close(g, w, f"{side} {na}x{nb} shared={shared}")


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("tile", [8, 16])
def test_b12_schedule_masks_as_plain_d2(monkeypatch, masses, tile):
    # One of b's bodies at the origin, four of a's along the axes at 1e-24
    # and 2^-75 (d2 == 0: masked) and at one float past 2^-75 and 1e-20 (d2
    # a denormal: w and u at the softening alone). Any other mask moves
    # a_bar and b_bar by ~softening^-1.5 m_b |g_a| = 1e3 |g_a| here.
    monkeypatch.setattr(sp, "PIECE_SLOTS", 5)
    soft = 1e-2
    pos_a, g_a, pos_b, m_a, m_b = map(_t, _inputs(40, 30, masses, False))
    pos_b[11] = 0.0
    edge = np.nextafter(np.float32(D2_ZERO), np.float32(1))
    for i, (k, x) in enumerate([(0, 1e-24), (1, D2_ZERO), (2, float(edge)),
                                (0, -1e-20)]):
        pos_a[5 + 9 * i] = 0.0
        pos_a[5 + 9 * i, k] = x
    d2 = ((pos_b[11] - pos_a[[5, 14, 23, 32]]) ** 2).sum(1)
    assert d2.tolist()[:2] == [0.0, 0.0] and (d2[2:] > 0).all()
    want = vk.vjp_pos_pair_plain(pos_a, g_a, pos_b, m_a, m_b, soft)
    got = b12_schedule(pos_a, g_a, pos_b, m_b, soft, tile)
    for g, w, side in zip(got, want, ("a_bar", "b_bar")):
        _close(g, w.numpy(), side)


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("na,nb,shared", CASES)
def test_b11_cross_with_zero_column_cotangents_is_b12(na, nb, shared,
                                                      masses):
    # B11's term w (m_a g_b - m_b g_a) + 3 u (m_b (g_a.d) - m_a (g_b.d)) d
    # with g_b = 0 is B12's t: its rows are a_bar, its reactions b_bar.
    tile, soft = 16, 1e-9
    pos_a, g_a, pos_b, m_a, m_b = map(_t, _inputs(na, nb, masses, shared))
    want = _jax(*(None if x is None else x.numpy()
                  for x in (pos_a, g_a, pos_b, m_a, m_b)), soft)
    na_p, nb_p = -(-na // tile) * tile, -(-nb // tile) * tile
    pa, pb = _pack(pos_a, m_a, na, na_p), _pack(pos_b, m_b, nb, nb_p)
    ga = vk._pad_rows(g_a, na_p)
    acc_a, acc_b = torch.zeros((na_p, 3)), torch.zeros((nb_p, 3))
    slots = sp.slot_table(na_p // tile, False, True, "cpu",
                          nb_b=nb_p // tile)
    vk.vjp_sym_sums_(acc_a, acc_b, pa, pb, ga, torch.zeros((nb_p, 3)), slots,
                     tile, soft, mask_offdiag=True)
    _close(acc_a[:na], want[0], "B11 rows")
    _close(acc_b[:nb], want[1], "B11 reactions")


@pytest.mark.parametrize("table", [("tri", 9), ("tri", 12), ("cross", 7),
                                   ("rect", (3, 11))])
@pytest.mark.parametrize("piece", [4, 16, 1 << 16])
def test_launch_order_is_longest_first_over_plan_pieces(monkeypatch, table,
                                                        piece):
    # reduce_plan carries plan_pieces' targets, offsets and entries as they
    # are, and a 6th field: the targets longest list first, ties in target
    # order (what csrc/slot_reduce.cu launches its CTAs in).
    monkeypatch.setattr(sp, "PIECE_SLOTS", piece)
    kind, nb = table
    if kind == "rect":
        slots = sp.slot_table(nb[0], False, True, "cpu", nb_b=nb[1])
    else:
        slots = sp.slot_table(nb, True, kind == "cross", "cpu")
    tri = kind == "tri"
    plans = sp.reduce_plan(slots, tri)
    want = sp.plan_pieces(slots.numpy(), tri)
    assert len(plans) == len(want)
    for plan, (s0, n, targets, offsets, entries) in zip(plans, want):
        assert plan[:2] == (s0, n)
        for got, ref in zip(plan[2:5], (targets, offsets, entries)):
            np.testing.assert_array_equal(got.numpy(), ref)
        order = plan[5].numpy()
        assert sorted(order) == list(range(len(targets)))
        lengths = np.diff(offsets)[order]
        assert (np.diff(lengths) <= 0).all()
        ties = lengths[1:] == lengths[:-1]
        assert (order[1:][ties] > order[:-1][ties]).all()
