"""Port vs JAX package: the ensemble gradients. make_differentiable_ensemble_
force, vjp_pos_sym_ensemble (B9c's plain path on the CPU) and
vjp_pos_sym_mxu_ensemble (B9d's), on the same numpy inputs as the JAX
package's ensemble VJPs in interpret mode under jax.disable_jit(), as
tests/test_ensemble.py:256-293 runs them (B = 3; N and tile (192, 64),
(300, 64) and (128, 128): 3, 5 (ragged) and 1 blocks per system).

Tolerances, each with its reason:
- gradients of sum(sin(F)) through the differentiable ensemble force:
  rtol 1e-3, atol 1e-4 of the scale, the JAX package's bound for its own
  ensemble gradients (tests/test_ensemble.py:210-229);
- vjp_pos_sym_ensemble: rtol 1e-3, atol 1e-4 of the scale, B11's bound in
  tests/test_torch_vjp.py (fp32 sums in another order, the slots here and
  the band there, and near-cancelling receiver and source sums);
- vjp_pos_sym_mxu_ensemble: rtol 1e-4, atol 1e-4 of the scale, B13's
  interpret-mode bound in tests/test_torch_vjp.py (both sides multiply in
  fp32 on the CPU).
The port against itself: every system bitwise its standalone VJP at the
same tile, no gradient in other systems from a loss on one, an in-system
duplicate under 'auto' routes to 'masked' (bitwise), duplicates across
systems never count. Inputs are np.float32 arrays, since tests/conftest.py
turns on jax_enable_x64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import autodiff as ja
from mini_nbody_tpu.ops import vjp_kernel as jv
from mini_nbody_tpu.ops import vjp_mxu as jm
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import SimConfig, make_differentiable_ensemble_force
from mini_nbody_tpu_torch.ops import autodiff as ta
from mini_nbody_tpu_torch.ops import vjp_kernel as vk
from mini_nbody_tpu_torch.ops import vjp_mxu as vm

torch.set_num_threads(1)

B = 3
SHAPES = [(192, 64), (300, 64), (128, 128)]
GRAD = (1e-3, 1e-4)
FP32 = (1e-3, 1e-4)
MXU_INTERP = (1e-4, 1e-4)


def _batch(n, masses=True, seed=0):
    rng = np.random.default_rng(seed + n)
    pos = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    g = np.sin(7.0 * pos).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, (B, n)).astype(np.float32) if masses else None
    return pos, g, mass


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1] * scale)


def _port_vjp(mxu):
    return vm.vjp_pos_sym_mxu_ensemble if mxu else vk.vjp_pos_sym_ensemble


def _port_one(mxu):
    return vm.vjp_pos_sym_mxu if mxu else vk.vjp_pos_sym


@pytest.mark.parametrize("backend", ["sym", "sym_mxu"])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("n,tile", SHAPES)
def test_ensemble_force_grad_vs_jax(backend, masses, n, tile):
    pos, _, mass = _batch(n, masses)
    kw = dict(n=n, backend=backend, sym_tile=tile, sym_bwd_tile=tile,
              use_masses=masses, softening=1e-2)
    jforce = ja.make_differentiable_ensemble_force(
        JSimConfig(interpret=True, **kw))

    def jloss(p):
        return jnp.sum(jnp.sin(jforce(p, _j(mass))))

    with jax.disable_jit():
        want = np.asarray(jax.grad(jloss)(_j(pos)))
    force = make_differentiable_ensemble_force(SimConfig(**kw))
    p = _t(pos).requires_grad_(True)
    torch.sin(force(p, _t(mass))).sum().backward()
    assert p.grad.shape == (B, n, 3)
    _close(p.grad, want, GRAD)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("n,tile", SHAPES)
def test_ensemble_vjp_mass_grad_vs_jax(mxu, n, tile):
    pos, g, mass = _batch(n, seed=1)
    jfn = jm.vjp_pos_sym_mxu_ensemble if mxu else jv.vjp_pos_sym_ensemble
    with jax.disable_jit():
        want = jfn(_j(pos), _j(g), _j(mass), softening=1e-2, tile=tile,
                   interpret=True, mass_grad=True)
    got = _port_vjp(mxu)(_t(pos), _t(g), _t(mass), 1e-2, tile=tile,
                         mass_grad=True)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, MXU_INTERP if mxu else FP32)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_ensemble_vjp_vs_jax(mxu, masses):
    pos, g, mass = _batch(200, masses, seed=2)
    jfn = jm.vjp_pos_sym_mxu_ensemble if mxu else jv.vjp_pos_sym_ensemble
    with jax.disable_jit():
        want = jfn(_j(pos), _j(g), _j(mass), softening=1e-2, tile=64,
                   interpret=True)
    got = _port_vjp(mxu)(_t(pos), _t(g), _t(mass), 1e-2, tile=64)
    _close(got, want, MXU_INTERP if mxu else FP32)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("n,tile", SHAPES)
def test_ensemble_vjp_bitwise_vs_standalone(mxu, masses, n, tile):
    # The default softening 1e-9: close pairs, and exact agreement all the
    # same. With masses the mass cotangent rides along (B11's 4th column,
    # B13's 9th).
    pos, g, mass = _batch(n, masses, seed=3)
    out = _port_vjp(mxu)(_t(pos), _t(g), _t(mass), tile=tile,
                         mass_grad=masses)
    out = out if masses else (out,)
    for i in range(B):
        ref = _port_one(mxu)(_t(pos[i]), _t(g[i]),
                             None if mass is None else _t(mass[i]),
                             tile=tile, mass_grad=masses)
        ref = ref if masses else (ref,)
        for a, b in zip(out, ref):
            assert torch.equal(a[i], b), i


@pytest.mark.parametrize("backend", ["sym", "sym_mxu"])
def test_ensemble_grad_bitwise_vs_standalone_grad(backend):
    # The forward at the ensemble's tile and chunk is bitwise the
    # standalone one, so the cotangent is too, and so the gradient.
    pos, _, mass = _batch(300, seed=4)
    cfg = SimConfig(n=300, backend=backend, sym_tile=64, sym_bwd_tile=64,
                    use_masses=True, softening=1e-2)
    p = _t(pos).requires_grad_(True)
    torch.sin(make_differentiable_ensemble_force(cfg)(p, _t(mass))).sum(
    ).backward()
    from mini_nbody_tpu_torch import make_differentiable_force

    one = make_differentiable_force(cfg)
    for i in range(B):
        q = _t(pos[i]).requires_grad_(True)
        torch.sin(one(q, _t(mass[i]))).sum().backward()
        assert torch.equal(p.grad[i], q.grad), i


@pytest.mark.parametrize("backend", ["sym", "sym_mxu"])
def test_no_cross_system_leakage(backend):
    pos, _, mass = _batch(200, seed=5)
    force = make_differentiable_ensemble_force(
        SimConfig(n=200, backend=backend, sym_tile=64, use_masses=True,
                  softening=1e-2))
    p = _t(pos).requires_grad_(True)
    (force(p, _t(mass))[0] ** 2).sum().backward()
    assert p.grad[0].abs().max() > 0
    assert torch.equal(p.grad[1:], torch.zeros_like(p.grad[1:]))


def test_masses_are_static():
    # JAX's backward gives the masses no gradient; here they get none.
    pos, _, mass = _batch(128, seed=6)
    force = make_differentiable_ensemble_force(
        SimConfig(n=128, backend="sym", use_masses=True, softening=1e-2))
    p = _t(pos).requires_grad_(True)
    m = _t(mass).requires_grad_(True)
    force(p, m).sum().backward()
    assert p.grad is not None and m.grad is None


@pytest.mark.parametrize("mxu", [False, True])
def test_within_system_duplicate_routes_masked(mxu, monkeypatch):
    # Gate at 0: 'auto' runs the per-system duplicate scan, which finds the
    # duplicate inside system 1 and takes the masked walk.
    mod = vm if mxu else vk
    monkeypatch.setattr(mod, "SYM_COINCIDENT_AUTO_MIN_N", 0)
    pos, g, mass = _batch(192, seed=7)
    pos[1, 150] = pos[1, 3]
    run = _port_vjp(mxu)
    auto = run(_t(pos), _t(g), _t(mass), tile=64, coincident="auto")
    masked = run(_t(pos), _t(g), _t(mass), tile=64, coincident="masked")
    assert torch.equal(auto, masked)
    assert torch.isfinite(auto).all()


@pytest.mark.parametrize("mxu", [False, True])
def test_duplicates_across_systems_never_count(mxu, monkeypatch):
    # Every system the same bodies: no pair across systems is computed, so
    # the scan finds nothing and 'auto' takes the maskless walk ('fast').
    mod = vm if mxu else vk
    monkeypatch.setattr(mod, "SYM_COINCIDENT_AUTO_MIN_N", 0)
    pos, g, mass = _batch(192, seed=8)
    pos[:] = pos[0]
    run = _port_vjp(mxu)
    auto = run(_t(pos), _t(g), _t(mass), tile=64, coincident="auto")
    fast = run(_t(pos), _t(g), _t(mass), tile=64, coincident="fast")
    assert torch.equal(auto, fast)


@pytest.mark.parametrize("mxu", [False, True])
def test_validation(mxu):
    pos, g, mass = _batch(64, seed=9)
    run = _port_vjp(mxu)
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        run(_t(pos[0]), _t(g[0]))
    with pytest.raises(ValueError, match="mass"):
        run(_t(pos), _t(g), None, mass_grad=True)
    with pytest.raises(ValueError, match="coincident"):
        run(_t(pos), _t(g), coincident="no")
    with pytest.raises(ValueError, match="sym_mxu"):
        make_differentiable_ensemble_force(SimConfig(n=64, backend="direct"))


def test_port_entry_points():
    assert ta.make_differentiable_ensemble_force is \
        make_differentiable_ensemble_force
