"""Port vs JAX package: body_force_sym_mxu (K2's plain path on the CPU) vs
the JAX slot-traversal body_force_sym_mxu in interpret mode, the coincident
routing, and the tiling rules.

Forces are held at rtol=0, atol=5e-6 of the force scale (the
accumulation-order bound of tests/test_slot_pipe.py:81: on the CPU both
sides multiply in fp32), and both against body_force_jnp at the
interpret-mode bound of tests/test_slot_pipe.py:24."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import sym_mxu_force as jsm
from mini_nbody_tpu.ops.reference import body_force_jnp
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.ops.force import body_force

torch.set_num_threads(1)

ATOL = 5e-6
RTOL_REF, ATOL_REF = 1e-4, 1e-5


def _state(n, seed, masses):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return pos, m


def _pair(pos, m, softening=1e-9, **kw):
    j = np.asarray(jsm.body_force_sym_mxu(
        jnp.asarray(pos), None if m is None else jnp.asarray(m),
        softening=softening, interpret=True, traversal="slots", **kw))
    t = sm.body_force_sym_mxu(torch.from_numpy(pos),
                              None if m is None else torch.from_numpy(m),
                              softening=softening, **kw).numpy()
    return j, t


def _scale(a):
    return max(np.abs(a).max(), 1.0)


@pytest.mark.parametrize("n,tile,chunk,masses", [
    (256, 64, 256, False),
    (300, 64, 128, True),      # multi-chunk, ragged tail
    (512, 64, 512, True),      # even block count
    (200, 64, 64, False),      # many chunks
    (96, 64, 128, True),       # fewer bodies than one tile
])
def test_sym_mxu_vs_jax(n, tile, chunk, masses):
    pos, m = _state(n, n, masses)
    j, t = _pair(pos, m, softening=1e-2, tile=tile, chunk=chunk)
    assert t.shape == (n, 3) and t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL * _scale(j))
    ref = np.asarray(body_force_jnp(jnp.asarray(pos), jnp.asarray(pos),
                                    None if m is None else jnp.asarray(m),
                                    softening=1e-2))
    np.testing.assert_allclose(t, ref, rtol=RTOL_REF,
                               atol=ATOL_REF * _scale(ref))


@pytest.mark.parametrize("coincident", ["masked", "fast"])
def test_sym_mxu_vs_jax_default_softening(coincident):
    pos, _ = _state(384, 5, False)
    j, t = _pair(pos, None, tile=64, chunk=128, coincident=coincident)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL * _scale(j))


def test_split_w_vs_jax():
    pos, m = _state(256, 8, True)
    j, t = _pair(pos, m, softening=1e-2, tile=64, chunk=256, split_w=True)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL * _scale(j))


def test_fast_bitwise_equals_masked_on_plain_path():
    # No coincident pair -> maskless w == masked w exactly and the same
    # accumulation order -> bitwise (tests/test_slot_pipe.py:84-93), on the
    # card too (tests/test_torch_gpu.py).
    pos = torch.from_numpy(_state(256, 3, False)[0])
    a = sm.body_force_sym_mxu(pos, tile=64, chunk=256, coincident="fast")
    b = sm.body_force_sym_mxu(pos, tile=64, chunk=256, coincident="masked")
    assert torch.equal(a, b)


@pytest.mark.parametrize("dups", [False, True])
def test_auto_bitwise_equals_masked_above_gate(dups, monkeypatch):
    # N = K2's gate, set to JAX's 8192: 'auto' runs the duplicate scan and
    # routes to the maskless (no duplicates) or masked (duplicates) kernel;
    # either way the result is bitwise the masked one.
    n = jsm.COINCIDENT_AUTO_MIN_N
    monkeypatch.setattr(sm, "COINCIDENT_AUTO_MIN_N", n)
    pos = np.random.default_rng(4).uniform(-1, 1, (n, 3)).astype(np.float32)
    if dups:
        pos[4000] = pos[5]
    p = torch.from_numpy(pos)
    assert sm.any_coincident(p) == dups
    a = sm.body_force_sym_mxu(p, tile=128, chunk=n, coincident="auto")
    b = sm.body_force_sym_mxu(p, tile=128, chunk=n, coincident="masked")
    assert torch.equal(a, b)
    assert torch.isfinite(a).all()


def test_duplicates_have_zero_mutual_force(oracle):
    pos, m = _state(256, 6, True)
    pos[130] = pos[3]
    pos[65] = pos[70]
    t = sm.body_force_sym_mxu(torch.from_numpy(pos), torch.from_numpy(m),
                              tile=64, chunk=256, coincident="masked").numpy()
    ref = oracle(pos, m)
    np.testing.assert_allclose(t, ref, rtol=RTOL_REF,
                               atol=ATOL_REF * _scale(ref))
    cloud = torch.full((128, 3), 0.5)
    assert torch.equal(sm.body_force_sym_mxu(cloud, tile=64),
                       torch.zeros(128, 3))


@pytest.mark.parametrize("coincident,n", [
    ("auto", 100), ("auto", 8191), ("auto", 8192), ("masked", 10),
    ("fast", 10**6)])
def test_resolve_auto_matches_jax(coincident, n):
    # The rule is JAX's; the gate is each module's own (K2's by default),
    # measured on the card.
    gate = jsm.COINCIDENT_AUTO_MIN_N
    assert sm.resolve_auto(coincident, n, gate) == jsm.resolve_auto(
        coincident, n)
    assert sm.resolve_auto(coincident, n) == sm.resolve_auto(
        coincident, n, sm.COINCIDENT_AUTO_MIN_N)


@pytest.mark.parametrize("n,tile,chunk", [
    (256, 64, 256), (300, 64, 128), (200, 64, 64), (7, 64, 131072),
    (1 << 20, 128, 131072)])
def test_resolve_tiling_matches_jax_interpret(n, tile, chunk):
    assert sm._resolve_tiling(n, tile, chunk, kernel=False) == \
        jsm._resolve_tiling(n, tile, chunk, interpret=True)


def test_kernel_tiling_keeps_the_tile():
    # The CUDA kernel is built for tiles 64 and 128 only: small N pads up.
    assert sm._resolve_tiling(7, 128, 131072, kernel=True) == (128, 128, 1,
                                                                128)
    assert sm._resolve_tiling(1 << 20, 128, 131072, kernel=True) == (
        128, 131072, 8, 1 << 20)


def test_arguments_rejected_like_jax():
    p = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        sm.body_force_sym_mxu(p, coincident="sometimes")
    with pytest.raises(ValueError):
        sm.body_force_sym_mxu(p, traversal="zigzag")
    # The band traversal is ported (B16, tests/test_torch_band.py).
    assert torch.equal(sm.body_force_sym_mxu(p, traversal="band"),
                       torch.zeros(8, 3))


def test_dispatcher_sym_mxu_vs_jax():
    pos, m = _state(256, 12, True)
    p = torch.from_numpy(pos)
    got = body_force(p, p, torch.from_numpy(m), backend="sym_mxu",
                     sym_tile=64, sym_chunk=128).numpy()
    want = np.asarray(jsm.body_force_sym_mxu(
        jnp.asarray(pos), jnp.asarray(m), tile=64, chunk=128,
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * _scale(want))
