"""Port vs JAX package: the 2-D grid backward's pair VJP (B12).

The same numpy inputs go through JAX's ``vjp_pos_pair`` (its Pallas kernel
in interpret mode) and the port's ``vjp_pos_pair_plain`` and
``vjp_pos_pair`` on the CPU: (a_bar, b_bar) of the ordered pairs a <- b with
a's cotangents only. Cases: ragged 37 x 53 and 64 x 128, masses and unit
mass, sets that share bodies (every shared body meets itself under the
d2 == 0 mask), softening 1e-9 and 1e-2, and FAR-padded tails.

Tolerance: rtol 1e-5, atol 1e-6 of each output's scale. Both sides are fp32
and evaluate the same terms; they differ only in the order of the sums
(Pallas tiles of up to 512 and a column buffer updated tile by tile there,
row blocks here). Inputs are np.float32 arrays: tests/conftest.py turns on
jax_enable_x64."""

import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import vjp_kernel as jv
from mini_nbody_tpu_torch.ops import vjp_kernel as vk
from mini_nbody_tpu_torch.utils.config import FAR

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _inputs(na, nb, masses, softening, shared, seed=0):
    """pos_a, g_a (na, 3), pos_b (nb, 3), masses or None; with ``shared``
    the first half of a's bodies are also the last of b's (the overlap of
    a 2-D grid tile's row and column groups)."""
    rng = np.random.default_rng(seed + 7 * na + nb)
    pos_a = rng.uniform(-1, 1, (na, 3)).astype(np.float32)
    pos_b = rng.uniform(-1, 1, (nb, 3)).astype(np.float32)
    m_a = rng.uniform(0.5, 2.0, na).astype(np.float32)
    m_b = rng.uniform(0.5, 2.0, nb).astype(np.float32)
    if shared:
        k = min(na, nb) // 2
        pos_b[nb - k:] = pos_a[:k]
        m_b[nb - k:] = m_a[:k]
    g_a = rng.normal(size=(na, 3)).astype(np.float32)
    if not masses:
        m_a = m_b = None
    return pos_a, g_a, pos_b, m_a, m_b


def _jax(pos_a, g_a, pos_b, m_a, m_b, softening):
    out = jv.vjp_pos_pair(pos_a, g_a, pos_b, m_a, m_b,
                          softening=softening, interpret=True)
    return [np.asarray(o) for o in out]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("softening", [1e-9, 1e-2])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("na,nb", [(37, 53), (64, 128)])
def test_pair_vjp_matches_jax(na, nb, shared, masses, softening):
    args = _inputs(na, nb, masses, softening, shared)
    want = _jax(*args, softening)
    plain = vk.vjp_pos_pair_plain(*map(_t, args), softening=softening)
    wrapped = vk.vjp_pos_pair(*map(_t, args), softening=softening)
    for got in (plain, wrapped):
        assert got[0].shape == (na, 3) and got[1].shape == (nb, 3)
        for g, w, side in zip(got, want, ("a_bar", "b_bar")):
            assert torch.isfinite(g).all()
            _close(g, w, f"{side} {na}x{nb} shared={shared}")


@pytest.mark.parametrize("masses", [False, True])
def test_far_padded_tails_are_inert(masses):
    # FAR sources (mass 0 in mass mode) and zero-cotangent receivers pad
    # the sets as a shard's tail does: the real rows match JAX on the
    # unpadded sets, and the pad rows get exactly zero.
    na, nb, pad = 37, 53, 11
    pos_a, g_a, pos_b, m_a, m_b = _inputs(na, nb, masses, 1e-9, True)
    want = _jax(pos_a, g_a, pos_b, m_a, m_b, 1e-9)
    pa = np.concatenate([pos_a, np.full((pad, 3), FAR, np.float32)])
    ga = np.concatenate([g_a, np.zeros((pad, 3), np.float32)])
    pb = np.concatenate([pos_b, np.full((pad, 3), FAR, np.float32)])
    ma = mb = None
    if masses:
        ma = np.concatenate([m_a, np.zeros(pad, np.float32)])
        mb = np.concatenate([m_b, np.zeros(pad, np.float32)])
    a_bar, b_bar = vk.vjp_pos_pair_plain(*map(_t, (pa, ga, pb, ma, mb)),
                                         softening=1e-9)
    _close(a_bar[:na], want[0], "a_bar real rows")
    _close(b_bar[:nb], want[1], "b_bar real rows")
    assert torch.equal(a_bar[na:], torch.zeros((pad, 3)))
    assert torch.equal(b_bar[nb:], torch.zeros((pad, 3)))


def test_pair_is_the_split_of_the_square_vjp():
    # With a = b = every body and g everywhere, a_bar + b_bar is the square
    # self-force VJP (B10's function): the receiver half plus the source
    # half of every ordered pair.
    pos, g, _, m, _ = _inputs(64, 64, True, 1e-2, False)
    a_bar, b_bar = vk.vjp_pos_pair_plain(_t(pos), _t(g), _t(pos), _t(m),
                                         _t(m), softening=1e-2)
    want = vk.vjp_ordered_plain(_t(pos), _t(g), _t(pos), _t(g), _t(m),
                                _t(m), 1e-2)
    _close(a_bar + b_bar, want.numpy(), "a_bar + b_bar vs B10")


def test_pair_refuses_one_mass():
    # Only the column masses are read: mass_a alone is refused, mass_b
    # alone is the masses case.
    pos_a, g_a, pos_b, m_a, m_b = map(_t, _inputs(8, 8, True, 1e-2, False))
    with pytest.raises(ValueError, match="mass_a without mass_b"):
        vk.vjp_pos_pair(pos_a, g_a, pos_b, m_a, None)
    both = vk.vjp_pos_pair(pos_a, g_a, pos_b, m_a, m_b)
    cols = vk.vjp_pos_pair(pos_a, g_a, pos_b, mass_b=m_b)
    for x, y in zip(both, cols):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="shape"):
        vk.vjp_pos_pair(pos_a, g_a[:4], pos_b)
