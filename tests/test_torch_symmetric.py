"""Port vs JAX package: the fp32 pair-once force. body_force_symmetric and
body_force_pair (K3's plain path on the CPU) against the JAX kernels in
interpret mode, the packing and tiling rules, zero masses, the identity
guard and 'auto' -> 'sym'.

Tolerance: rtol 1e-4, atol 1e-5 of the force scale, the bound
tests/test_pallas_force.py:85 holds the JAX kernel to: both sides are fp32
and differ in the traversal (slots here, the band there), so only in the
order of the sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import symmetric_force as jsf
from mini_nbody_tpu.ops.force import body_force as j_body_force
from mini_nbody_tpu_torch import SimConfig, make_force_fn
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import symmetric_force as sf
from mini_nbody_tpu_torch.ops.force import body_force
from mini_nbody_tpu_torch.ops.sym_mxu_force import _resolve_tiling

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _state(n, seed, masses):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return pos, m


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("n,tile,chunk", [
    (256, 64, 256),   # single chunk
    (300, 64, 128),   # three chunks with a ragged, far-padded tail
    (512, 64, 512),   # even block count
])
@pytest.mark.parametrize("masses", [False, True])
def test_body_force_symmetric_vs_jax(n, tile, chunk, masses, oracle):
    pos, m = _state(n, n, masses)
    want = jsf.body_force_symmetric(_j(pos), _j(m), tile=tile, chunk=chunk,
                                    interpret=True)
    got = sf.body_force_symmetric(_t(pos), _t(m), tile=tile, chunk=chunk)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    _close(got, want)
    _close(got, oracle(pos, m))


@pytest.mark.parametrize("softening", [1e-2, 1e-15])
def test_softening_paths_vs_jax(softening):
    # 1e-15 < 1e-12 takes the rsqrt(r2)^3 path of both kernels.
    pos, m = _state(200, 3, True)
    want = jsf.body_force_symmetric(_j(pos), _j(m), softening=softening,
                                    tile=64, chunk=128, interpret=True)
    _close(sf.body_force_symmetric(_t(pos), _t(m), softening=softening,
                                   tile=64, chunk=128), want)


@pytest.mark.parametrize("masses", [False, True])
def test_fold_and_unfolded_slot_walks_agree(masses):
    # The same self chunk through the folded and the unfolded slot list.
    n, tile = 256, 64
    pos, m = _state(n, 4, masses)
    p = sf._pack(_t(pos), _t(m), n, n)
    out = []
    for fold in (False, True):
        acc = torch.zeros((n, 3))
        sf.symmetric_sums_plain(acc, acc, p, p,
                                sp.slot_table(n // tile, fold, False, "cpu"),
                                tile, 1e-9)
        out.append(acc)
    _close(out[1], out[0])
    _close(out[1], jsf.body_force_symmetric(_j(pos), _j(m), tile=tile,
                                            chunk=n, interpret=True))


@pytest.mark.parametrize("n,np_,masses", [(300, 384, False), (300, 384, True),
                                          (128, 128, True)])
def test_pack_matches_jax(n, np_, masses):
    pos, m = _state(n, 5, masses)
    got = sf._pack(_t(pos), _t(m), n, np_)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsf._pack(_j(pos), _j(m), n,
                                                       np_)))


@pytest.mark.parametrize("n,tile,chunk", [(256, 64, 256), (300, 64, 128),
                                          (7, 64, 131072)])
def test_resolve_tiling_matches_jax_interpret(n, tile, chunk):
    assert _resolve_tiling(n, tile, chunk, kernel=False) == \
        jsf._resolve_tiling(n, tile, chunk, masses=False, interpret=True)


@pytest.mark.parametrize("masses", [False, True])
def test_body_force_pair_vs_jax(masses):
    pa, ma = _state(96, 7, masses)
    pb, mb = _state(200, 8, masses)
    pb += 3.0
    ja, jb = jsf.body_force_pair(_j(pa), _j(pb), _j(ma), _j(mb), tile=64,
                                 interpret=True)
    ta, tb = sf.body_force_pair(_t(pa), _t(pb), _t(ma), _t(mb), tile=64)
    assert ta.shape == (96, 3) and tb.shape == (200, 3)
    _close(ta, ja)
    _close(tb, jb)


def test_body_force_pair_needs_both_masses_or_neither():
    p = np.zeros((8, 3), np.float32)
    m = np.ones(8, np.float32)
    with pytest.raises(ValueError, match="both masses or neither"):
        jsf.body_force_pair(_j(p), _j(p + 1.0), _j(m), None, interpret=True)
    with pytest.raises(ValueError, match="both masses or neither"):
        sf.body_force_pair(_t(p), _t(p + 1.0), _t(m), None)


def test_zero_masses_inert_and_single_body_zero():
    pos, _ = _state(128, 9, False)
    f = sf.body_force_symmetric(_t(pos), torch.zeros(128), tile=64,
                                chunk=128)
    assert torch.equal(f, torch.zeros(128, 3))
    one = sf.body_force_symmetric(_t(pos[:1]))
    assert torch.equal(one, torch.zeros(1, 3))


def test_identity_guard_like_jax():
    pos, _ = _state(64, 10, False)
    with pytest.raises(ValueError, match="same array object"):
        j_body_force(_j(pos), _j(pos) + 0.0, backend="sym")
    p = _t(pos)
    with pytest.raises(ValueError, match="same tensor"):
        body_force(p, p.clone(), backend="sym")
    with pytest.raises(ValueError):
        body_force(p, p, backend="sym", traversal="band")


def test_dispatcher_sym_vs_jax():
    pos, m = _state(256, 11, True)
    jp = _j(pos)
    want = j_body_force(jp, jp, _j(m), backend="sym", sym_tile=64,
                        sym_chunk=128, interpret=True)
    p = _t(pos)
    _close(body_force(p, p, _t(m), backend="sym", sym_tile=64,
                      sym_chunk=128), want)


def test_auto_runs_sym_on_the_cpu_without_counting():
    pos, m = _state(200, 12, True)
    p = _t(pos)
    before = (sf.LAUNCHES, sf.CROSS_LAUNCHES)
    cfg = SimConfig(n=200, use_masses=True)
    got = make_force_fn(cfg)(p, p, _t(m))
    assert (sf.LAUNCHES, sf.CROSS_LAUNCHES) == before
    assert torch.equal(got, sf.body_force_symmetric(p, _t(m)))
    # A rectangular 'auto' call takes the ordered fp32 kernel instead.
    q = _t(_state(50, 13, False)[0])
    _close(body_force(q, p, _t(m), backend="auto"),
           body_force(q, p, _t(m), backend="direct"))


def test_wrapper_checks_inputs():
    p = sf._pack(_t(_state(128, 14, False)[0]), None, 128, 128)
    acc = torch.zeros(128, 3)
    slots = sp.slot_table(2, True, False, "cpu")
    with pytest.raises(TypeError):
        sf.symmetric_sums_(acc, acc, p.double(), p.double(), slots, 64, 1e-9)
    with pytest.raises(ValueError):
        sf.symmetric_sums_(acc, acc, p[:100], p[:100], slots, 64, 1e-9)
    with pytest.raises(ValueError):
        sf.symmetric_sums_(acc, acc, p[:, :2].contiguous(),
                           p[:, :2].contiguous(), slots, 64, 1e-9)
    with pytest.raises(TypeError):
        sf.symmetric_sums_(acc, acc, p, p, slots.long(), 64, 1e-9)
