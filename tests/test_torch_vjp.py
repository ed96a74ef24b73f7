"""Port vs JAX package: the force VJP kernels' plain versions.

The same numpy inputs go through each JAX VJP (Pallas kernels in interpret
mode, tile 64) and its port counterpart on the CPU (the kernels' plain
versions, which walk the slot lists the CUDA kernels walk):
vjp_pos_sym (B11), vjp_pos_pallas -> vjp_pos_direct and vjp_pos_rect (B10),
vjp_pos_sym_mxu (B13) and vjp_rect_mxu (B14). Cases: unit mass, masses,
ragged N (FAR-padded tails), mass_grad, and softening 1e-9 with two distinct
coincident bodies, where an unmasked pair would swamp the fp32 sums.

Tolerances, each with its reason:
- B10, B11: rtol 1e-3, atol 1e-4 of the scale, the bound the JAX package
  holds its own fp32 VJPs to (tests/test_autodiff.py:34); both sides are
  fp32 and differ only in the order of the sums (slots and chunks here, the
  band there), but the VJP's receiver and source sums nearly cancel.
- B13, B14 in fp32 (the plain versions' default, JAX's interpret run):
  rtol 1e-4, atol 1e-4 of the scale, JAX's own interpret-mode bound
  (tests/test_vjp_mxu.py:19).
- Their bf16-mode plain versions against the fp32 VJP: rtol 2e-2, atol 5e-3
  of the scale, the on-card bf16-accumulate bound of the force
  (tests/test_slot_pipe.py:24).
Inputs are np.float32 arrays: tests/conftest.py turns on jax_enable_x64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import autodiff as ja
from mini_nbody_tpu.ops import vjp_kernel as jv
from mini_nbody_tpu.ops import vjp_mxu as jm
from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.ops import autodiff as ta
from mini_nbody_tpu_torch.ops import direct_force as df
from mini_nbody_tpu_torch.ops import pe_kernel as pk
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.ops import symmetric_force as sf
from mini_nbody_tpu_torch.ops import vjp_kernel as vk
from mini_nbody_tpu_torch.ops import vjp_mxu as vm

torch.set_num_threads(1)

FP32 = (1e-3, 1e-4)
MXU_INTERP = (1e-4, 1e-4)
BF16 = (2e-2, 5e-3)

#: (n, masses, softening): the last two put bodies 3 and 200 at one point.
CASES = [(256, False, 1e-2), (300, True, 1e-2), (300, False, 1e-9),
         (300, True, 1e-9)]


def _inputs(n, masses, softening, seed=0):
    rng = np.random.default_rng(seed + n)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if softening < 1e-6:
        pos[200] = pos[3]
    g = rng.normal(size=(n, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return pos, g, m


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1] * scale)


@pytest.mark.parametrize("n,masses,softening", CASES)
@pytest.mark.parametrize("chunk", [131072, 128])
def test_vjp_pos_sym_vs_jax(n, masses, softening, chunk):
    # chunk 128 runs three self chunks and three chunk pairs (cross mode).
    pos, g, m = _inputs(n, masses, softening)
    want = jv.vjp_pos_sym(_j(pos), _j(g), _j(m), softening, tile=64,
                          interpret=True)
    got = vk.vjp_pos_sym(_t(pos), _t(g), _t(m), softening, tile=64,
                         chunk=chunk)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    _close(got, want, FP32)


@pytest.mark.parametrize("n,softening", [(300, 1e-2), (300, 1e-9)])
@pytest.mark.parametrize("chunk", [131072, 128])
def test_vjp_pos_sym_mass_grad_vs_jax(n, softening, chunk):
    pos, g, m = _inputs(n, True, softening, seed=1)
    want = jv.vjp_pos_sym(_j(pos), _j(g), _j(m), softening, tile=64,
                          interpret=True, mass_grad=True)
    got = vk.vjp_pos_sym(_t(pos), _t(g), _t(m), softening, tile=64,
                         chunk=chunk, mass_grad=True)
    for a, b in zip(got, want):
        _close(a, b, FP32)


@pytest.mark.parametrize("n,masses,softening,coincident", [
    (*case, mode) for case in CASES for mode in ("auto", "masked", "fast")
    if mode != "fast" or case[2] > 1e-6])  # 'fast' promises no coincidence
def test_vjp_pos_direct_vs_jax_pallas(n, masses, softening, coincident):
    pos, g, m = _inputs(n, masses, softening, seed=2)
    want = jv.vjp_pos_pallas(_j(pos), _j(g), _j(m), softening, tile_i=64,
                             tile_j=128, interpret=True,
                             coincident=coincident)
    got = vk.vjp_pos_direct(_t(pos), _t(g), _t(m), softening,
                            coincident=coincident)
    _close(got, want, FP32)


@pytest.mark.parametrize("n,masses,softening", CASES)
def test_vjp_pos_rect_vs_jax(n, masses, softening):
    pos, g, m = _inputs(n, masses, softening, seed=3)
    k = slice(0, 100) if softening > 1e-6 else slice(150, 250)  # holds 200
    mk = None if m is None else m[k]
    want = jv.vjp_pos_rect(_j(pos[k]), _j(g[k]), _j(pos), _j(g), _j(mk),
                           _j(m), softening, tile_i=64, tile_j=128,
                           interpret=True)
    got = vk.vjp_pos_rect(_t(pos[k].copy()), _t(g[k].copy()), _t(pos),
                          _t(g), _t(None if mk is None else mk.copy()),
                          _t(m), softening)
    _close(got, want, FP32)


@pytest.mark.parametrize("n,masses,softening", CASES)
@pytest.mark.parametrize("chunk", [131072, 128])
def test_vjp_pos_sym_mxu_vs_jax(n, masses, softening, chunk):
    pos, g, m = _inputs(n, masses, softening, seed=4)
    want = jm.vjp_pos_sym_mxu(_j(pos), _j(g), _j(m), softening, tile=64,
                              interpret=True)
    got = vm.vjp_pos_sym_mxu(_t(pos), _t(g), _t(m), softening, tile=64,
                             chunk=chunk)
    _close(got, want, MXU_INTERP)


@pytest.mark.parametrize("softening", [1e-2, 1e-9])
def test_vjp_pos_sym_mxu_mass_grad_vs_jax(softening):
    pos, g, m = _inputs(300, True, softening, seed=5)
    want = jm.vjp_pos_sym_mxu(_j(pos), _j(g), _j(m), softening, tile=64,
                              interpret=True, mass_grad=True)
    got = vm.vjp_pos_sym_mxu(_t(pos), _t(g), _t(m), softening, tile=64,
                             chunk=128, mass_grad=True)
    for a, b in zip(got, want):
        _close(a, b, MXU_INTERP)


@pytest.mark.parametrize("n,masses,softening", CASES)
@pytest.mark.parametrize("square", [True, False])
def test_vjp_rect_mxu_vs_jax(n, masses, softening, square):
    pos, g, m = _inputs(n, masses, softening, seed=6)
    if square:  # the autodiff call beyond _SYM_BWD_MAX: pos_k is pos_j
        jp, tp = _j(pos), _t(pos)
        jargs = (jp, _j(g), jp, _j(g), _j(m), _j(m))
        targs = (tp, _t(g), tp, _t(g), _t(m), _t(m))
        kw = dict(coincident="auto")
    else:
        k = slice(150, 250)
        mk = None if m is None else m[k].copy()
        jargs = (_j(pos[k]), _j(g[k]), _j(pos), _j(g), _j(mk), _j(m))
        targs = (_t(pos[k].copy()), _t(g[k].copy()), _t(pos), _t(g), _t(mk),
                 _t(m))
        kw = {}
    want = jm.vjp_rect_mxu(*jargs, softening=softening, tile=64,
                           interpret=True, **kw)
    got = vm.vjp_rect_mxu(*targs, softening=softening, **kw)
    _close(got, want, MXU_INTERP)


@pytest.mark.parametrize("masses,softening", [(False, 1e-2), (True, 1e-9)])
def test_bf16_mode_plain_versions_stay_in_class(masses, softening):
    # The bf16-mode plain sums (what the card's B13 and B14 are held to)
    # rounded through the combine, against the fp32 chunked VJP.
    n, tile = 300, 64
    pos, g, m = _inputs(n, masses, softening, seed=7)
    tp, tg, tm = _t(pos), _t(g), _t(m)
    ref = ta._vjp_pos(tp, tg, tm if masses else torch.ones(n), softening)
    (_, _, _, np_), (p, gp, q) = vm.sums_inputs(tp, tg, tm if masses
                                                else None, tile)
    acc = torch.zeros((np_, 8))
    vm.vjp_mxu_sums_plain(acc, acc, p, p, gp, gp, q, q,
                          sp.slot_table(np_ // tile, True, False, "cpu"),
                          tile, softening, True, mma_dtype=torch.bfloat16)
    mf = p[:, 3] if masses else torch.ones(np_)
    _close(vm._combine(acc, mf, gp, p[:, :3])[:n], ref, BF16)
    rows = vm.vjp_rect_mxu_plain(tp, tg, tp, tg, tm, tm, softening,
                                 mma_dtype=torch.bfloat16)
    _close(vm._combine(rows, tm if masses else torch.ones(n), tg, tp), ref,
           BF16)


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("mxu", [False, True])
def test_fold_and_unfolded_slot_walks_agree(masses, mxu):
    n, tile = 256, 64
    pos, g, m = _inputs(n, masses, 1e-2, seed=8)
    p = sf._pack(_t(pos), _t(m), n, n)
    gp = _t(g)
    out = []
    for fold in (False, True):
        slots = sp.slot_table(n // tile, fold, False, "cpu")
        if mxu:
            acc = torch.zeros((n, 8))
            q = vm._operands(p, gp)
            vm.vjp_mxu_sums_plain(acc, acc, p, p, gp, gp, q, q, slots, tile,
                                  1e-2, True)
        else:
            acc = torch.zeros((n, 3))
            vk.vjp_sym_sums_plain(acc, acc, p, p, gp, gp, slots, tile, 1e-2,
                                  True)
        out.append(acc)
    _close(out[1], out[0], MXU_INTERP)


def test_zero_cotangent_and_translation_invariance():
    pos, g, m = _inputs(200, True, 1e-2, seed=9)
    tp, tm = _t(pos), _t(m)
    zero = torch.zeros(200, 3)
    for fn in (vk.vjp_pos_sym, vk.vjp_pos_direct, vm.vjp_pos_sym_mxu):
        assert torch.equal(fn(tp, zero, tm, 1e-2), zero)
    # The VJP depends on positions only through differences.
    shift = torch.tensor([3.0, -2.0, 1.0])
    for fn, tol in ((vk.vjp_pos_sym, FP32), (vm.vjp_pos_sym_mxu, FP32)):
        _close(fn(tp + shift, _t(g), tm, 1e-2), fn(tp, _t(g), tm, 1e-2),
               tol)


def test_single_body_has_zero_gradient():
    p, g = torch.zeros(1, 3), torch.ones(1, 3)
    for fn in (vk.vjp_pos_sym, vk.vjp_pos_direct, vm.vjp_pos_sym_mxu):
        assert torch.equal(fn(p, g, None, 1e-9), torch.zeros(1, 3))


def test_arguments_rejected_like_jax():
    p = torch.zeros(8, 3)
    for fn in (vk.vjp_pos_sym, vm.vjp_pos_sym_mxu):
        with pytest.raises(ValueError, match="mass"):
            fn(p, p, mass_grad=True)
        with pytest.raises(ValueError):
            fn(p, p, coincident="sometimes")
    m = torch.ones(8)
    with pytest.raises(ValueError, match="both masses or neither"):
        vk.vjp_pos_rect(p, p, p, p, m, None)
    with pytest.raises(ValueError, match="both masses or neither"):
        vm.vjp_rect_mxu(p, p, p, p, None, m)
    with pytest.raises(ValueError):
        vk.vjp_pos_direct(p, p, coincident="never")


def test_wrappers_check_inputs():
    n, tile = 128, 64
    p = sf._pack(torch.zeros(n, 3), None, n, n)
    g = torch.zeros(n, 3)
    slots = sp.slot_table(n // tile, True, False, "cpu")
    acc = torch.zeros(n, 3)
    with pytest.raises(TypeError):
        vk.vjp_sym_sums_(acc, acc, p.double(), p.double(), g, g, slots,
                         tile, 1e-9)
    with pytest.raises(ValueError):
        vk.vjp_sym_sums_(acc, acc, p[:100], p[:100], g[:100], g[:100], slots,
                         tile, 1e-9)
    with pytest.raises(ValueError, match="4 in mass mode"):
        vk.vjp_sym_sums_(torch.zeros(n, 4), torch.zeros(n, 4), p, p, g, g,
                         slots, tile, 1e-9)
    with pytest.raises(TypeError):
        vk.vjp_sym_sums_(acc, acc, p, p, g, g, slots.long(), tile, 1e-9)
    q = vm._operands(p, g)
    acc8 = torch.zeros(n, 8)
    with pytest.raises(ValueError, match="9 in mass mode"):
        vm.vjp_mxu_sums_(torch.zeros(n, 9), torch.zeros(n, 9), p, p, g, g,
                         q, q, slots, tile, 1e-9)
    with pytest.raises(ValueError):
        vm.vjp_mxu_sums_(acc8, acc8, p, p, g, g, q[:, :8].contiguous(),
                         q[:, :8].contiguous(), slots, tile, 1e-9)
    with pytest.raises(ValueError):
        vk.vjp_pos_rect(p, g[:5], p, g)
    with pytest.raises(TypeError):
        vm.vjp_rect_mxu(p.double(), g, p, g)


class _Launched(Exception):
    """Raised by a stand-in for the kernel library: the wrapper got past
    every check and was about to launch."""


def _no_library():
    raise _Launched


WRAPPERS = ("direct (K1)", "fused Euler (K5)", "sym (K3)", "sym_mxu (K2)",
            "potential (K4)", "vjp_pos_direct (B10)", "vjp_pos_sym (B11)",
            "vjp_pos_sym_mxu (B13)", "vjp_rect_mxu (B14)")


def _wrapper_calls():
    """Each kernel wrapper of the port (WRAPPERS), called on CPU tensors
    that the test passes off as card tensors."""
    rng = np.random.default_rng(10)
    pos = torch.from_numpy(rng.uniform(-1, 1, (64, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    return {
        "direct (K1)": lambda p: df.body_force_direct(p, p),
        "fused Euler (K5)": lambda p: df.euler_step_fused(p, g),
        "sym (K3)": lambda p: sf.body_force_symmetric(p),
        "sym_mxu (K2)": lambda p: sm.body_force_sym_mxu(p),
        "potential (K4)": lambda p: pk.potential_energy_kernel(p),
        "vjp_pos_direct (B10)": lambda p: vk.vjp_pos_direct(p, g),
        "vjp_pos_sym (B11)": lambda p: vk.vjp_pos_sym(p, g),
        "vjp_pos_sym_mxu (B13)": lambda p: vm.vjp_pos_sym_mxu(p, g),
        "vjp_rect_mxu (B14)": lambda p: vm.vjp_rect_mxu(p, g, p, g),
    }, pos


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_refuse_inputs_that_require_grad(monkeypatch, name):
    # On the card a kernel's output has no autograd history: a wrapper given
    # an input that requires grad under grad mode raises, naming the
    # differentiable entry point, instead of cutting the gradient silently.
    calls, pos = _wrapper_calls()
    assert tuple(calls) == WRAPPERS
    monkeypatch.setattr(_build, "on_card", lambda device: True)
    monkeypatch.setattr(_build, "load_library", _no_library)
    p = pos.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="make_differentiable_force"):
        calls[name](p)
    with torch.no_grad(), pytest.raises(_Launched):
        calls[name](p)
    with pytest.raises(_Launched):
        calls[name](pos)


@pytest.mark.parametrize("backend", ["torch", "direct"])
def test_plain_versions_stay_differentiable_on_the_cpu(backend):
    # A CPU tensor takes the plain version, and the refusal does not reach
    # it: autograd differentiates the plain all-pairs ops like JAX's jnp
    # backend, and the gradient is the analytic VJP.
    from mini_nbody_tpu_torch.ops.force import body_force

    pos, g, m = _inputs(200, True, 1e-2, seed=11)
    p = _t(pos).clone().requires_grad_(True)
    f = body_force(p, p, _t(m), softening=1e-2, backend=backend)
    (f * _t(g)).sum().backward()
    want = ja._vjp_pos(_j(pos), _j(g), _j(m), 1e-2)
    _close(p.grad, want, FP32)
