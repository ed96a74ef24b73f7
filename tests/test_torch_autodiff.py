"""Port vs JAX package: the differentiable force (ops/autodiff.py).

make_differentiable_force over every ported backend against JAX's on the
same numpy inputs (Pallas forwards and backwards in interpret mode, the
port's on the kernels' plain versions), the mass cotangent, the routing by
precision class and across _SYM_BWD_MAX (monkeypatched down on both sides,
as tests/test_vjp_mxu.py:133 does), the pair-once route of a CUDA tensor
at every N (the device test patched), a finite-difference check and
torch.autograd.gradcheck in float64, and the default softening against a
float64 reference with the self pair excluded.

Tolerances: gradients of the fp32 class at rtol 1e-3, atol 1e-4 of the
scale (the JAX package's own bound for its VJPs, tests/test_autodiff.py:34:
fp32 sums in another order, with the receiver and source sums nearly
cancelling); sym_mxu's backward in fp32 (CPU) at the same bound, since
JAX's interpret run and the plain version both multiply in fp32; the
finite difference at rtol 1e-4 in float64 (tests/test_autodiff.py:138)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.models import init as jinit
from mini_nbody_tpu.ops import autodiff as ja
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import SimConfig, make_differentiable_force
from mini_nbody_tpu_torch.ops import autodiff as ta
from mini_nbody_tpu_torch.ops import vjp_kernel as vk
from mini_nbody_tpu_torch.ops import vjp_mxu as vm
from mini_nbody_tpu_torch.ops.reference import body_force_torch

torch.set_num_threads(1)

FP32 = (1e-3, 1e-4)
#: port backend -> JAX backend
JAX_NAME = {"torch": "jnp", "direct": "pallas", "sym": "sym",
            "sym_mxu": "sym_mxu", "auto": "auto"}


def _close(got, want, tol=FP32):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-9)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1] * scale)


def _plummer(n, seed):
    s = jinit.plummer(jax.random.key(seed), n)
    g = np.array(jax.random.normal(jax.random.key(seed + 1), (n, 3)),
                 np.float32)
    return np.array(s.pos, np.float32), np.array(s.mass, np.float32), g


def _cfgs(n, backend, **kw):
    jcfg = JSimConfig(n=n, backend=JAX_NAME[backend], tile_i=64,
                      tile_j=128, sym_tile=64, sym_bwd_tile=64,
                      interpret=True, **kw)
    return jcfg, SimConfig(n=n, backend=backend, tile_i=64, sym_tile=64,
                           sym_bwd_tile=64, **kw)


def _jax_loss(force, pos, mass):
    return jnp.sum(jnp.sin(force(pos, mass)) * jnp.cos(pos))


def _torch_loss(force, pos, mass):
    return (torch.sin(force(pos, mass)) * torch.cos(pos)).sum()


@pytest.mark.parametrize("backend", ["torch", "direct", "sym", "sym_mxu",
                                     "auto"])
@pytest.mark.parametrize("masses", [False, True])
def test_grad_matches_jax(backend, masses):
    n = 96
    pos, mass, _ = _plummer(n, 0)
    jcfg, cfg = _cfgs(n, backend, softening=1e-2, use_masses=masses)
    jm = jnp.asarray(mass) if masses else None
    jf = ja.make_differentiable_force(jcfg)
    want = jax.grad(lambda p: _jax_loss(jf, p, jm))(jnp.asarray(pos))
    p = torch.from_numpy(pos).requires_grad_(True)
    _torch_loss(make_differentiable_force(cfg), p,
                torch.from_numpy(mass) if masses else None).backward()
    _close(p.grad, want)


def test_unit_mass_backward_ignores_passed_masses():
    # use_masses=False: the forward ignores a passed mass, and so does every
    # backward. JAX's jnp backward weights the gradient by the passed masses
    # (autodiff.py:219), a reference fault the port does not copy.
    n = 80
    pos, mass, g = _plummer(n, 1)
    grads = []
    for backend in ("torch", "sym", "sym_mxu"):
        cfg = SimConfig(n=n, backend=backend, softening=1e-2)
        for m in (None, torch.from_numpy(mass)):
            p = torch.from_numpy(pos).requires_grad_(True)
            make_differentiable_force(cfg)(p, m).backward(
                torch.from_numpy(g))
            grads.append(p.grad)
    for got in grads[1:]:
        _close(got, grads[0])


@pytest.mark.parametrize("backend", ["torch", "sym", "sym_mxu"])
def test_mass_grad_matches_jax(backend):
    n = 150
    pos, mass, g = _plummer(n, 2)
    jcfg, cfg = _cfgs(n, backend, softening=1e-2, use_masses=True)
    jf = ja.make_differentiable_force(jcfg, mass_grad=True)
    _, vjp = jax.vjp(jf, jnp.asarray(pos), jnp.asarray(mass))
    want_p, want_m = vjp(jnp.asarray(g))
    p = torch.from_numpy(pos).requires_grad_(True)
    m = torch.from_numpy(mass).requires_grad_(True)
    f = make_differentiable_force(cfg, mass_grad=True)(p, m)
    f.backward(torch.from_numpy(g))
    _close(p.grad, want_p)
    _close(m.grad, want_m)


@pytest.mark.parametrize("backend", ["torch", "sym", "sym_mxu"])
def test_mass_cotangent_is_zero_without_mass_grad(backend):
    n = 64
    pos, mass, g = _plummer(n, 3)
    _, cfg = _cfgs(n, backend, softening=1e-2, use_masses=True)
    p = torch.from_numpy(pos).requires_grad_(True)
    m = torch.from_numpy(mass).requires_grad_(True)
    make_differentiable_force(cfg)(p, m).backward(torch.from_numpy(g))
    assert torch.equal(m.grad, torch.zeros(n))
    assert p.grad.abs().max() > 0


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("backend,n,mass_grad,route", [
    ("sym", 120, False, "vjp_pos_sym"),
    ("sym", 200, False, "vjp_pos_direct"),
    ("direct", 200, False, "vjp_pos_direct"),
    ("sym", 120, True, "vjp_pos_sym"),
    ("sym", 200, True, "_vjp_pos"),
    ("sym_mxu", 120, False, "vjp_pos_sym_mxu"),
    ("sym_mxu", 200, False, "vjp_rect_mxu"),
    ("sym_mxu", 120, True, "vjp_pos_sym_mxu"),
    ("sym_mxu", 200, True, "_vjp_pos"),
    ("torch", 120, False, "_vjp_pos"),
])
def test_routing_across_the_bound_matches_jax(monkeypatch, backend, n,
                                              mass_grad, route):
    # _SYM_BWD_MAX down to 128 on both sides: n = 120 takes the pair-once
    # backwards (B11, B13), n = 200 the ordered ones (B10, B14 called
    # square), and mass_grad beyond the bound the chunked VJP on the CPU,
    # as in JAX.
    monkeypatch.setattr(ta, "_SYM_BWD_MAX", 128)
    monkeypatch.setattr(ja, "_SYM_BWD_MAX", 128)
    calls = []
    for mod, name in ((vk, "vjp_pos_sym"), (vk, "vjp_pos_direct"),
                      (vm, "vjp_pos_sym_mxu"), (vm, "vjp_rect_mxu"),
                      (ta, "_vjp_pos")):
        _spy(monkeypatch, mod, name, calls)
    pos, mass, g = _plummer(n, 4)
    jcfg, cfg = _cfgs(n, backend, softening=1e-2, use_masses=True)
    jf = ja.make_differentiable_force(jcfg, mass_grad=mass_grad)
    _, vjp = jax.vjp(jf, jnp.asarray(pos), jnp.asarray(mass))
    want = vjp(jnp.asarray(g))
    p = torch.from_numpy(pos).requires_grad_(True)
    m = torch.from_numpy(mass).requires_grad_(mass_grad)
    make_differentiable_force(cfg, mass_grad=mass_grad)(p, m).backward(
        torch.from_numpy(g))
    assert calls == [route]
    _close(p.grad, want[0])
    if mass_grad:
        _close(m.grad, want[1])


def test_mass_grad_beyond_the_bound_takes_b11_on_the_card(monkeypatch):
    # A routing change against JAX: on a CUDA tensor, mass_grad beyond
    # _SYM_BWD_MAX goes to B11 (chunked, no single-launch bound) instead of
    # the chunked plain VJP, so no plain version runs on the card's path.
    from mini_nbody_tpu_torch import _build

    n = 200
    pos, mass, g = _plummer(n, 5)
    p, m, tg = (torch.from_numpy(a) for a in (pos, mass, g))
    want = ta._vjp_pos(p, tg, m, 1e-2, with_mass_grad=True)
    calls = []

    def b11(pos, g, mass=None, **kw):
        calls.append(kw)
        return want

    monkeypatch.setattr(ta, "_SYM_BWD_MAX", 128)
    monkeypatch.setattr(_build, "on_card", lambda device: True)
    monkeypatch.setattr(vk, "vjp_pos_sym", b11)
    out = ta._route(p, tg, m, 1e-2, "fp32", False, 256, True, None, "auto")
    assert len(calls) == 1 and calls[0]["mass_grad"] is True
    assert out[0] is want[0] and out[1] is want[1]


@pytest.mark.parametrize("card,backward,mass_grad,route,kernel", [
    (True, "bf16", False, "vjp_pos_sym_mxu", "B13"),
    (True, "fp32", False, "vjp_pos_sym", "B11"),
    (True, "bf16", True, "vjp_pos_sym_mxu", "B13"),
    (True, "fp32", True, "vjp_pos_sym", "B11"),
    (False, "bf16", False, "vjp_rect_mxu", "B14"),
    (False, "fp32", False, "vjp_pos_direct", "B10"),
    (False, "bf16", True, "_vjp_pos", "torch"),
    (False, "fp32", True, "_vjp_pos", "torch"),
])
def test_the_card_takes_the_pair_once_vjp_at_every_n(
        monkeypatch, card, backward, mass_grad, route, kernel):
    # Beyond _SYM_BWD_MAX, as set, a CUDA tensor (the device test patched)
    # keeps the pair-once backward of its class, B13 or B11, with the mass
    # cotangent when asked; a CPU tensor takes JAX's route, the ordered B14
    # or B10, or the plain VJP for mass_grad. route.vjp.* names the kernel.
    from mini_nbody_tpu_torch import _build
    from mini_nbody_tpu_torch.utils import tracing

    n = ta._SYM_BWD_MAX + 1
    p, tg = torch.zeros((n, 3)), torch.ones((n, 3))
    m = torch.ones(n)
    out, mass_out = torch.zeros_like(p), torch.zeros_like(m)
    calls = []

    def stub(name):
        def kernel_call(*args, **kw):
            calls.append((name, kw.get("mass_grad", kw.get("with_mass_grad",
                                                           False))))
            return (out, mass_out) if mass_grad else out
        return kernel_call

    monkeypatch.setattr(_build, "on_card", lambda device: card)
    for mod, name in ((vk, "vjp_pos_sym"), (vk, "vjp_pos_direct"),
                      (vm, "vjp_pos_sym_mxu"), (vm, "vjp_rect_mxu"),
                      (ta, "_vjp_pos")):
        monkeypatch.setattr(mod, name, stub(name))
    before = tracing.counters()
    got = ta._route(p, tg, m, 1e-2, backward, False, 256, mass_grad, None,
                    "auto")
    assert calls == [(route, mass_grad)]
    assert got[0] is out and got[1] is (mass_out if mass_grad else None)
    assert dict(tracing.counters() - before) == {f"route.vjp.{kernel}": 1}


def test_finite_difference():
    # Directional derivative by central differences in float64.
    rng = np.random.default_rng(6)
    pos = torch.from_numpy(rng.uniform(-1, 1, (32, 3)))
    v = torch.from_numpy(rng.normal(size=(32, 3)))
    soft = 1e-2
    force = make_differentiable_force(
        SimConfig(n=32, backend="torch", softening=soft))
    p = pos.clone().requires_grad_(True)
    torch.sin(force(p)).sum().backward()

    def loss(q):
        return torch.sin(body_force_torch(q, q, softening=soft)).sum()

    eps = 1e-6
    fd = (loss(pos + eps * v) - loss(pos - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float((p.grad * v).sum()), float(fd),
                               rtol=1e-4)


def test_gradcheck_positions_and_masses():
    # torch.autograd.gradcheck: the analytic VJP against finite differences
    # of the whole Jacobian, positions and masses, in float64.
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(rng.uniform(-1, 1, (12, 3))).requires_grad_(True)
    mass = torch.from_numpy(rng.uniform(0.5, 2.0, 12)).requires_grad_(True)
    cfg = SimConfig(n=12, backend="torch", softening=1e-2, use_masses=True)
    force = make_differentiable_force(cfg, mass_grad=True)
    assert torch.autograd.gradcheck(force, (pos, mass))


def _ref_vjp_f64(pos, g, mass, softening):
    """float64 pos_bar with the self pair excluded (autograd through the
    masked all-pairs force): the exact gradient, free of the eps^-1.5
    cancellation residue."""
    p = torch.from_numpy(pos).double().requires_grad_(True)
    m = torch.from_numpy(mass).double()
    d = p[None, :, :] - p[:, None, :]
    r2 = (d * d).sum(-1) + softening
    w = r2 ** -1.5 * m[None, :] * (1.0 - torch.eye(p.shape[0],
                                                   dtype=torch.float64))
    f = (d * w[:, :, None]).sum(1)
    f.backward(torch.from_numpy(g).double())
    return p.grad.numpy()


@pytest.mark.parametrize("use_masses", [False, True])
def test_grad_at_default_softening(use_masses):
    # At softening 1e-9 the self weight is ~3e13: without the d2 == 0 mask
    # the fp32 cancellation destroys the gradient (ops/autodiff.py).
    from mini_nbody_tpu_torch.utils.config import SOFTENING

    n = 256
    pos, mass, g = _plummer(n, 8)
    if not use_masses:
        mass = np.ones(n, np.float32)
    ref = _ref_vjp_f64(pos, g, mass, SOFTENING)
    p, tg = torch.from_numpy(pos), torch.from_numpy(g)
    m = torch.from_numpy(mass) if use_masses else None
    _close(ta._vjp_pos(p, tg, torch.from_numpy(mass), SOFTENING), ref)
    for fn in (vk.vjp_pos_direct, vk.vjp_pos_sym):
        _close(fn(p, tg, m, SOFTENING), ref)


def test_bf16_class_matches_jax():
    for backend in ("torch", "direct", "sym", "sym_mxu", "auto"):
        jcfg, cfg = _cfgs(64, backend)
        assert cfg.bf16_class() == jcfg.bf16_class(), backend


def test_mass_grad_requires_masses():
    cfg = SimConfig(n=8, backend="sym", use_masses=False)
    with pytest.raises(ValueError, match="mass"):
        make_differentiable_force(cfg, mass_grad=True)
    with pytest.raises(ValueError, match="backward"):
        ta.make_body_force_diff(lambda p, m: p, 1e-2, backward="pallas")


def test_sym_bwd_tile_is_ported_for_the_card_tiles():
    import dataclasses

    for tile in (None, 64, 128):
        jcfg = JSimConfig(n=64, sym_bwd_tile=tile)
        assert SimConfig.from_dict(
            dataclasses.asdict(jcfg)).sym_bwd_tile == tile
    # JAX's VMEM-sized tiles are not built for the card.
    with pytest.raises(ValueError, match="sym_bwd_tile"):
        SimConfig.from_dict(dataclasses.asdict(JSimConfig(n=64,
                                                          sym_bwd_tile=640)))
    with pytest.raises(ValueError, match="sym_bwd_tile"):
        SimConfig(n=64, sym_bwd_tile=96)


def test_sym_bwd_tile_and_coincident_reach_the_backward(monkeypatch):
    calls = []
    real = vk.vjp_pos_sym

    def spy(*args, **kw):
        calls.append((kw["tile"], kw["coincident"]))
        return real(*args, **kw)

    monkeypatch.setattr(vk, "vjp_pos_sym", spy)
    pos, mass, g = _plummer(100, 9)
    grads = []
    for mode in ("fast", "masked"):
        cfg = SimConfig(n=100, backend="sym", softening=1e-2,
                        sym_bwd_tile=128, coincident=mode)
        p = torch.from_numpy(pos).requires_grad_(True)
        (make_differentiable_force(cfg)(p) ** 2).sum().backward()
        grads.append(p.grad)
    assert calls == [(128, "fast"), (128, "masked")]
    # Without coincident bodies the maskless walk is the masked one.
    assert torch.equal(grads[0], grads[1])
