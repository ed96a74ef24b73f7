"""Port vs JAX package: the plain all-pairs force (body_force_torch vs
body_force_jnp) and K1's plain version (direct_force_plain, which
body_force_direct takes for CPU tensors) vs body_force_pallas in interpret
mode, both against the fp64 oracle of conftest.

Tolerance: rtol 1e-4, atol 1e-5 of the force scale, the bound
tests/test_pallas_force.py holds the Pallas kernel to: both sides are fp32
and differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops.pallas_force import body_force_pallas
from mini_nbody_tpu.ops.reference import body_force_jnp
from mini_nbody_tpu_torch.ops import direct_force as df
from mini_nbody_tpu_torch.ops.force import body_force
from mini_nbody_tpu_torch.ops.reference import body_force_torch

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _inputs(ni, nj, masses, seed=0):
    rng = np.random.default_rng(seed)
    pj = rng.uniform(-1, 1, (nj, 3)).astype(np.float32)
    pi = pj[:ni].copy() if ni == nj else rng.uniform(
        -1, 1, (ni, 3)).astype(np.float32)
    m = rng.uniform(0.1, 2.0, nj).astype(np.float32) if masses else None
    return pi, pj, m


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("n,masses,row_chunk", [
    (8, False, None), (100, True, None), (300, False, 64), (300, True, 7)])
def test_body_force_torch_vs_jnp(n, masses, row_chunk):
    pi, pj, m = _inputs(n, n, masses)
    want = body_force_jnp(_j(pi), _j(pj), _j(m))
    got = body_force_torch(_t(pi), _t(pj), _t(m), row_chunk=row_chunk)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("ni,nj,masses", [
    (256, 256, False), (256, 256, True), (7, 7, False), (7, 7, True),
    (300, 300, False), (300, 300, True), (96, 200, True), (64, 640, False)])
def test_direct_plain_vs_pallas(ni, nj, masses):
    pi, pj, m = _inputs(ni, nj, masses, seed=ni + nj)
    want = body_force_pallas(_j(pi), _j(pj), _j(m), tile_i=64, tile_j=128,
                             interpret=True)
    got = df.direct_force_plain(_t(pi), _t(pj), _t(m))
    _close(got, want)


@pytest.mark.parametrize("softening", [1e-2, 1e-15])
def test_direct_plain_softening_paths(softening):
    # 1e-15 < 1e-12 takes the rsqrt(r2)^3 path of both kernels.
    pi, pj, m = _inputs(128, 128, True, seed=3)
    want = body_force_pallas(_j(pi), _j(pj), _j(m), softening=softening,
                             tile_i=64, tile_j=128, interpret=True)
    _close(df.direct_force_plain(_t(pi), _t(pj), _t(m), softening), want)


@pytest.mark.parametrize("masses", [False, True])
def test_single_body_force_is_exactly_zero(masses):
    pi, pj, m = _inputs(1, 1, masses)
    f = df.body_force_direct(_t(pi), _t(pj), _t(m))
    assert torch.equal(f, torch.zeros(1, 3))
    assert np.all(np.asarray(body_force_pallas(
        _j(pi), _j(pj), _j(m), interpret=True)) == 0.0)


@pytest.mark.parametrize("masses", [False, True])
def test_direct_and_torch_vs_fp64_oracle(masses, oracle):
    pi, pj, m = _inputs(300, 300, masses, seed=11)
    want = oracle(pi, m)
    _close(df.body_force_direct(_t(pi), _t(pj), _t(m)), want)
    _close(body_force_torch(_t(pi), _t(pj), _t(m)), want)


def test_wrapper_takes_plain_on_cpu_without_counting():
    pi, pj, m = _inputs(50, 80, True)
    before = df.LAUNCHES
    got = df.body_force_direct(_t(pi), _t(pj), _t(m))
    assert df.LAUNCHES == before
    assert torch.equal(got, df.direct_force_plain(_t(pi), _t(pj), _t(m)))


def test_wrapper_checks_inputs():
    pi, pj, m = _inputs(16, 16, True)
    with pytest.raises(TypeError):
        df.body_force_direct(_t(pi).double(), _t(pj))
    with pytest.raises(ValueError):
        df.body_force_direct(_t(pi)[:, :2], _t(pj))
    with pytest.raises(ValueError):
        df.body_force_direct(_t(pi), _t(pj), _t(m)[:8])
    with pytest.raises(ValueError):
        df.body_force_direct(torch.from_numpy(
            np.asfortranarray(pi)), _t(pj))


@pytest.mark.parametrize("backend", ["torch", "direct", "auto"])
def test_dispatcher_backends_vs_jnp(backend):
    pi, pj, m = _inputs(200, 200, True, seed=2)
    want = body_force_jnp(_j(pi), _j(pj), _j(m))
    _close(body_force(_t(pi), _t(pj), _t(m), backend=backend), want)


def test_dispatcher_rejects_unknown_and_unported():
    p = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError):
        body_force(p, p, backend="mxu")
    with pytest.raises(ValueError):
        body_force(p, p, backend="pallas")
    with pytest.raises(ValueError):
        body_force(p, p.clone(), backend="sym_mxu")
