"""Port vs JAX package: the mxu backend (ops/mxu_force.py, B6's plain
version on the CPU) against JAX's body_force_mxu in interpret mode
(tile_i=64, tile_j=128), the coincident routing, the config, the dispatcher,
simulate and the differentiable force.

Tolerances: forces at rtol 1e-3, atol 1e-4 of max|F| (K1's bound): on the
CPU both sides multiply in fp32 whatever pair_dtype is (JAX's interpret run,
tests/test_mxu_force.py:3-5; the port's plain version with mma_dtype
float32), and sum in other orders; the fp32 class sums w d on the port's side
and w [p | 1] on JAX's. The bf16 class against the fp64 oracle: median
per-body error below 1e-2 (tests/test_mxu_force.py:66-75), also with W and
the operand rounded to bf16 as the tensor cores do. auto and fast against
masked: bitwise. simulate at rtol 1e-4, atol 1e-5 of the scale
(tests/test_torch_sim.py); gradients at the fp32 VJP bound, rtol 1e-3, atol
1e-4 (tests/test_torch_autodiff.py). Inputs are np.float32, since
conftest.py turns on jax_enable_x64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu import sim as jsim
from mini_nbody_tpu.models import init as jinit
from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.ops import autodiff as ja
from mini_nbody_tpu.ops.mxu_force import body_force_mxu as j_mxu
from mini_nbody_tpu.utils.config import SimConfig as JSimConfig
from mini_nbody_tpu_torch import (BodyState, SimConfig, body_force,
                                  make_differentiable_force, simulate)
from mini_nbody_tpu_torch.ops import autodiff as ta
from mini_nbody_tpu_torch.ops import mxu_force as mf
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.ops import vjp_kernel as vk
from mini_nbody_tpu_torch.ops import vjp_mxu as vm

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4
KW = dict(tile_i=64, tile_j=128)
JAX_DTYPE = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _uniform(seed, n, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _both(pos_i, pos_j, mass_j=None, pair_dtype="bfloat16", square=False,
          **kw):
    """(JAX, port) forces on the same numpy inputs; square passes one array
    object as both sides on each side."""
    ji, tj = _j(pos_i), _t(pos_i)
    jj = ji if square else _j(pos_j)
    tj_ = tj if square else _t(pos_j)
    want = np.asarray(j_mxu(ji, jj, _j(mass_j), interpret=True,
                            pair_dtype=JAX_DTYPE[pair_dtype], **KW, **kw))
    got = mf.body_force_mxu(tj, tj_, _t(mass_j), pair_dtype=pair_dtype,
                            **KW, **kw)
    assert got.dtype == torch.float32 and got.shape == (pos_i.shape[0], 3)
    return want, got.numpy()


# The cases of tests/test_mxu_force.py, each in both precision classes.
CASES = {
    "self_pairs_192": lambda: (_uniform(0, 192), None, None),
    "far_tail_100": lambda: (_uniform(1, 100), None, None),
    "masses_rect_64x256": lambda: (
        _uniform(2, 64), _uniform(3, 256),
        np.random.default_rng(4).uniform(0.5, 2.0, 256).astype(np.float32)),
    "fp32_contract_128": lambda: (_uniform(5, 128), None, None),
}


@pytest.mark.parametrize("pair_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mxu_vs_jax(case, pair_dtype, oracle, oracle_rect):
    pos_i, pos_j, m = CASES[case]()
    square = pos_j is None
    want, got = _both(pos_i, pos_j, m, pair_dtype, square=square)
    _close(got, want)
    ref = (oracle(pos_i, None) if square
           else oracle_rect(pos_i, pos_j, m))
    # The fp32 class against the fp64 oracle at JAX's own fp32 bound
    # (tests/test_mxu_force.py:61-63).
    _close(got, ref, *((1e-4, 1e-4) if pair_dtype == "float32"
                       else (2e-3, 2e-3)))


@pytest.mark.parametrize("pair_dtype", ["bfloat16", "float32"])
def test_all_coincident_bodies_exactly_zero(pair_dtype):
    pos = np.zeros((64, 3), np.float32)
    want, got = _both(pos, None, pair_dtype=pair_dtype, square=True)
    assert (got == 0.0).all() and (want == 0.0).all()
    cloud = torch.full((64, 3), 0.5)
    f = mf.body_force_mxu(cloud, cloud, pair_dtype=pair_dtype,
                          coincident="auto")
    assert torch.equal(f, torch.zeros(64, 3))


@pytest.mark.parametrize("mma_dtype", [torch.float32, torch.bfloat16])
def test_bf16_class_vs_fp64_oracle(mma_dtype):
    # The accuracy envelope of tests/test_mxu_force.py:66-75; with
    # mma_dtype=bfloat16 the plain version rounds W and the compensated
    # operand as the tensor cores do, the version B6 is held to on the card.
    s = jinit.uniform_random(jax.random.key(7), 512)
    pos = np.array(s.pos, np.float32)
    p = torch.from_numpy(pos)
    sums = mf.hybrid_sums_plain(p, p, None, 1e-3, mma_dtype=mma_dtype)
    f = mf._epilogue(p, sums).numpy().astype(np.float64)
    ref = _f64(pos, 1e-3)
    per_body = np.abs(f - ref).max(1) / (np.abs(ref).max(1) + 1e-6)
    assert np.median(per_body) < 1e-2
    if mma_dtype == torch.float32:
        jf = np.asarray(j_mxu(jnp.asarray(pos), jnp.asarray(pos),
                              interpret=True, pair_dtype=jnp.bfloat16,
                              softening=1e-3))
        _close(f, jf)


def _f64(pos, softening):
    p = pos.astype(np.float64)
    d = p[None, :, :] - p[:, None, :]
    r2 = (d * d).sum(-1) + softening
    return (d * (r2 ** -1.5)[:, :, None]).sum(1)


def test_plain_sums_layout():
    # bf16 class: (N, 8) [hi | lo] raw sums of W @ [p | 1]; fp32 class:
    # (N, 3) sums of w d, which are the forces.
    p = torch.from_numpy(_uniform(8, 100))
    s8 = mf.hybrid_sums_plain(p, p, None, 1e-2, **KW)
    s3 = mf.hybrid_sums_plain(p, p, None, 1e-2, **KW, pair_dtype="float32")
    assert s8.shape == (100, 8) and s3.shape == (100, 3)
    _close(mf._epilogue(p, s8).numpy(), s3.numpy())
    assert torch.equal(mf._epilogue(p, s3), s3)


class TestCoincidentRouting:
    """tests/test_mxu_force.py:78-123 on the port: square calls route
    coincident; rectangular calls always mask."""

    @pytest.mark.parametrize("pair_dtype", ["bfloat16", "float32"])
    def test_square_bitwise(self, pair_dtype):
        p = torch.from_numpy(_uniform(51, 300))
        m = torch.from_numpy(np.random.default_rng(9).uniform(
            0.5, 2.0, 300).astype(np.float32))
        ref = mf.body_force_mxu(p, p, m, pair_dtype=pair_dtype,
                                coincident="masked", **KW)
        for mode in ("auto", "fast"):
            got = mf.body_force_mxu(p, p, m, pair_dtype=pair_dtype,
                                    coincident=mode, **KW)
            assert torch.equal(got, ref), mode

    def test_auto_above_the_gate_bitwise(self, monkeypatch):
        # N = B6's gate, set to 8192: 'auto' runs the duplicate scan and
        # takes the overlap run, bitwise the masked one.
        n = 8192
        monkeypatch.setattr(mf, "COINCIDENT_AUTO_MIN_N", n)
        p = torch.from_numpy(_uniform(10, n))
        assert mf.square_overlap_only(p, "auto")
        ref = mf.body_force_mxu(p, p, coincident="masked", tile_i=2048,
                                tile_j=2048)
        got = mf.body_force_mxu(p, p, coincident="auto", tile_i=2048,
                                tile_j=2048)
        assert torch.equal(got, ref)

    def test_square_duplicates_route_to_masked(self):
        pos = _uniform(52, 300)
        pos[200] = pos[3]  # crosses both tile sizes
        want, got = _both(pos, None, square=True, coincident="auto",
                          softening=1e-9)
        p = torch.from_numpy(pos)
        ref = mf.body_force_mxu(p, p, coincident="masked", **KW)
        assert torch.equal(torch.from_numpy(got), ref)
        assert np.isfinite(got).all()
        _close(got, want)
        # Above the gate the scan must see the pair.
        big = _uniform(53, 8192)
        big[4000] = big[5]
        assert not mf.square_overlap_only(torch.from_numpy(big), "auto")

    def test_rect_embedded_ignores_fast(self):
        pos = _uniform(53, 300)
        p = torch.from_numpy(pos)
        sub = p[:200]
        ref = mf.body_force_mxu(sub, p, coincident="masked", **KW)
        got = mf.body_force_mxu(sub, p, coincident="fast", **KW)
        assert torch.equal(got, ref)
        assert torch.isfinite(got).all()
        jw = np.asarray(j_mxu(jnp.asarray(pos[:200]), jnp.asarray(pos),
                              coincident="fast", interpret=True,
                              pair_dtype=jnp.bfloat16, **KW))
        _close(got.numpy(), jw)

    def test_validation(self):
        p = torch.zeros(64, 3)
        with pytest.raises(ValueError, match="coincident"):
            mf.body_force_mxu(p, p, coincident="no")
        with pytest.raises(ValueError, match="pair_dtype"):
            mf.body_force_mxu(p, p, pair_dtype="float16")
        with pytest.raises(ValueError, match="pair_dtype"):
            SimConfig(n=8, backend="mxu", pair_dtype="float16")


@pytest.mark.parametrize("mode,n,dup,want", [
    ("masked", 9000, False, False), ("fast", 10, True, True),
    ("auto", 100, False, False), ("auto", 8192, False, True),
    ("auto", 8192, True, False)])
def test_square_overlap_only(mode, n, dup, want, monkeypatch):
    # B6's gate at 8192.
    monkeypatch.setattr(mf, "COINCIDENT_AUTO_MIN_N", 8192)
    pos = _uniform(11, n)
    if dup:
        pos[n - 1] = pos[0]
    assert mf.square_overlap_only(torch.from_numpy(pos), mode) == want


@pytest.mark.parametrize("pair_dtype", ["bfloat16", "float32"])
def test_config_and_dispatcher(pair_dtype):
    jcfg = JSimConfig(n=300, backend="mxu", pair_dtype=pair_dtype,
                      tile_i=64, tile_j=128, use_masses=True,
                      coincident="masked", interpret=True)
    cfg = SimConfig.from_dict(dataclasses.asdict(jcfg))
    assert cfg.backend == "mxu" and cfg.pair_dtype == pair_dtype
    assert cfg.bf16_class() == jcfg.bf16_class() == (pair_dtype
                                                     == "bfloat16")
    pos = _uniform(12, 300)
    m = np.random.default_rng(13).uniform(0.5, 2.0, 300).astype(np.float32)
    p = torch.from_numpy(pos)
    from mini_nbody_tpu.ops.force import make_force_fn as j_make_force_fn
    from mini_nbody_tpu_torch import make_force_fn

    jp = jnp.asarray(pos)
    want = np.asarray(j_make_force_fn(jcfg)(jp, jp, jnp.asarray(m)))
    _close(make_force_fn(cfg)(p, p, torch.from_numpy(m)).numpy(), want)
    # Rectangular through the dispatcher.
    got = body_force(p[:100], p, torch.from_numpy(m), backend="mxu",
                     pair_dtype=pair_dtype, tile_i=64, tile_j=128)
    _close(got.numpy(), np.asarray(j_mxu(
        jp[:100], jp, jnp.asarray(m), interpret=True,
        pair_dtype=JAX_DTYPE[pair_dtype], **KW)))


@pytest.mark.parametrize("pair_dtype", ["bfloat16", "float32"])
def test_simulate_vs_jax(pair_dtype):
    rng = np.random.default_rng(14)
    n = 300
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = (rng.uniform(-1, 1, (n, 3)) * 0.1).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jcfg = JSimConfig(n=n, steps=4, softening=1e-2, backend="mxu",
                      pair_dtype=pair_dtype, integrator="leapfrog",
                      use_masses=True, tile_i=64, tile_j=128, interpret=True)
    j = jsim.simulate(jcfg, JBodyState.create(pos, vel, mass))
    cfg = SimConfig.from_dict(dataclasses.asdict(jcfg))
    t = simulate(cfg, BodyState.from_numpy(pos, vel, mass, device="cpu"))
    for got, want in zip(t.to_numpy()[:2], (j.pos, j.vel)):
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("pair_dtype,n,route", [
    ("bfloat16", 256, "vjp_pos_sym_mxu"), ("float32", 256, "vjp_pos_sym"),
    ("bfloat16", 300, "vjp_rect_mxu"), ("float32", 300, "vjp_pos_direct")])
def test_differentiable_force_vs_jax_grad(monkeypatch, pair_dtype, n, route):
    # mxu in the bf16 class takes the bf16 backward (B13, or B14 beyond
    # _SYM_BWD_MAX), in the fp32 class the fp32 one (B11, B10), as JAX's
    # make_differentiable_force routes it. The bound is lowered to 256 on
    # both sides, so n = 300 crosses it.
    monkeypatch.setattr(ta, "_SYM_BWD_MAX", 256)
    monkeypatch.setattr(ja, "_SYM_BWD_MAX", 256)
    calls = []
    for mod, name in ((vk, "vjp_pos_sym"), (vk, "vjp_pos_direct"),
                      (vm, "vjp_pos_sym_mxu"), (vm, "vjp_rect_mxu"),
                      (ta, "_vjp_pos")):
        _spy(monkeypatch, mod, name, calls)
    s = jinit.plummer(jax.random.key(15), n)
    pos = np.array(s.pos, np.float32)
    mass = np.array(s.mass, np.float32)
    kw = dict(n=n, backend="mxu", pair_dtype=pair_dtype, softening=1e-2,
              use_masses=True, tile_i=64, tile_j=128, sym_bwd_tile=64)
    jf = ja.make_differentiable_force(JSimConfig(interpret=True, **kw))
    jm = jnp.asarray(mass)
    want = jax.grad(lambda p: jnp.sum(jnp.sin(jf(p, jm)) * jnp.cos(p)))(
        jnp.asarray(pos))
    p = torch.from_numpy(pos).requires_grad_(True)
    force = make_differentiable_force(SimConfig(**kw))
    (torch.sin(force(p, torch.from_numpy(mass))) * torch.cos(p)).sum(
    ).backward()
    assert calls == [route]
    _close(p.grad.numpy(), np.asarray(want))
