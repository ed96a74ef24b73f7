"""The row schedule of K1, K5 (csrc/direct_force.cu) and K4
(csrc/pe_kernel.cu), written in PyTorch as the kernels compute it, against
the JAX package on the CPU.

A launch over n rows at ``block`` takes (R, rows) = direct_force.row_schedule
(n, block) (K4: pe_kernel.schedule, whose rows a CTA shrink at small n):
CTAs of ``rows`` rows and rows / R threads, thread t owning rows
c0 + t + (rows / R) r, r < R, and j tiles of ``rows`` sources. Every row adds
its terms in j order, 0, 1, ..., n - 1 and then the tile's pads, into one
fp32 running sum, so no bit depends on R or the tile. K4 selects 0 for the
self pair on the CTA's own j tile only (the only tile that meets the
diagonal) and pads with zero mass; K1 and K5 pad with FAR. The rsqrt form is
the host's choice from the softening (direct_force.rsqrt_form):
rsqrt.approx.ftz (modelled as rsqrt of the input with denormals flushed to
zero) where the input is provably normal, rsqrtf below FLT_MIN.

The models are held to JAX's body_force_pallas (``_direct_kernel``),
euler_step_fused (``_fused_euler_kernel``) and potential_energy_pallas
(``_pe_kernel``) in interpret mode, at small n with ragged edges, in both
mass modes and both fast_rsqrt_cube modes: forces at rtol 1e-4, atol 1e-5
of the scale (tests/test_torch_direct_force.py: fp32 sums in another
order), the fused step at rtol 1e-5, atol 1e-6 of the scale
(tests/test_torch_fused_euler.py), U within 1e-5 of |U|
(tests/test_torch_diagnostics.py). The card tests (tests/test_torch_gpu.py)
hold the kernels bitwise across every (R, rows) the launcher takes.

Inputs are np.float32 arrays: tests/conftest.py turns on jax_enable_x64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops.pallas_force import body_force_pallas
from mini_nbody_tpu.ops.pallas_force import euler_step_fused as j_fused
from mini_nbody_tpu.ops.pe_kernel import potential_energy_pallas
from mini_nbody_tpu_torch.ops import direct_force as df
from mini_nbody_tpu_torch.ops import pe_kernel as pk

torch.set_num_threads(1)

FAR = 1.0e18
FORCE_TOL, FUSED_TOL, U_RTOL = (1e-4, 1e-5), (1e-5, 1e-6), 1e-5


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1] * scale)


def _inputs(n, masses, seed):
    rng = np.random.default_rng(seed + n)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = (rng.uniform(-1, 1, (n, 3)) * 0.1).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return pos, vel, m


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def threads_rows(n, block):
    """For each CTA of a launch over n rows at ``block``, each thread's rows
    (in bounds or not): thread t owns c0 + t + (rows / R) r, r < R."""
    r, rows = df.row_schedule(n, block)
    threads = rows // r
    return [[[c0 + t + threads * q for q in range(r)]
             for t in range(threads)] for c0 in range(0, n, rows)]


def rsqrt_model(x, form):
    """rsqrt in ``form``: rsqrt.approx.ftz (FORM_NORMAL, FORM_CUBE) flushes
    a denormal input to zero; rsqrtf (FORM_RSQRTF) does not."""
    if form == df.FORM_RSQRTF:
        return torch.rsqrt(x)
    return torch.rsqrt(torch.where(x.abs() < df.FLT_MIN,
                                   torch.zeros_like(x), x))


def direct_model(pos_i, pos_j, mass_j, softening, block, form=None):
    """K1's sums as the kernel forms them: every row (rows past Ni too, at
    the origin) one running fp32 sum over j in order, the last tile padded
    with (FAR, 0); form: the host's rsqrt_form unless given."""
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    _, rows = df.row_schedule(ni, block)
    form = df.rsqrt_form(softening) if form is None else form
    ni_p, nj_p = -(-ni // rows) * rows, -(-nj // rows) * rows
    xi = torch.zeros((ni_p, 3))
    xi[:ni] = pos_i
    src = torch.full((nj_p, 3), FAR)
    src[:nj] = pos_j
    m = torch.zeros(nj_p)
    m[:nj] = 1.0 if mass_j is None else mass_j
    f = torch.zeros((ni_p, 3))
    for k in range(nj_p):
        d = src[k] - xi
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        r2 = dx * dx + dy * dy + (dz * dz + softening)
        if form == df.FORM_CUBE:
            w = rsqrt_model((r2 * r2) * r2, form)
        else:
            inv = rsqrt_model(r2, form)
            w = (inv * inv) * inv
        if mass_j is not None:
            w = w * m[k]
        f = f + d * w[:, None]
    return f[:ni]


def fused_model(pos, vel, mass, dt, softening, block):
    """K5: K1's sums, then v' = v + dt F and p' = p + dt v', each product
    and sum rounded once (the epilogue's __fmul_rn / __fadd_rn)."""
    v = vel + dt * direct_model(pos, pos, mass, softening, block)
    return pos + dt * v, v


def pe_model(pos, mass, softening, block, form=None):
    """K4's row sums as the kernel forms them: every row one running fp32
    sum over j in order, the last tile padded with (0, 0, 0, mass 0), the
    self pair's rsqrt selected to 0 on the CTA's own tile only."""
    n = pos.shape[0]
    _, rows = df.row_schedule(n, block)
    form = df.rsqrt_form(softening, cube=False) if form is None else form
    n_p = -(-n // rows) * rows
    xi = torch.zeros((n_p, 3))
    xi[:n] = pos
    m = torch.zeros(n_p)
    m[:n] = 1.0 if mass is None else mass
    own_tile = torch.arange(n_p) // rows
    acc = torch.zeros(n_p)
    for k in range(n_p):
        d = xi[k] - xi
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        inv = rsqrt_model(dx * dx + dy * dy + (dz * dz + softening), form)
        diag = own_tile == k // rows  # the CTAs whose own tile this is
        inv = torch.where(diag & (torch.arange(n_p) == k),
                          torch.zeros_like(inv), inv)
        acc = acc + m[k] * inv
    return acc[:n]


# ------------------------------------------------------------ schedule ---

@pytest.mark.parametrize("n,block,r", [
    (300, 128, 1), (3001, 256, 1), (65536, 512, 1), (131072, 512, 1),
    (262144, 512, 2), (262144, 1024, 2), (524288, 512, 4),
    (1 << 20, 512, 4), (1 << 20, 96, 1), (1 << 20, 64, 2)])
def test_row_schedule(n, block, r):
    got_r, rows = df.row_schedule(n, block)
    assert (got_r, rows) == (r, block)
    assert rows % (32 * r) == 0  # whole warps
    for big in (x for x in df.ROWS_A_THREAD if x > r):
        # a larger R splits a warp or leaves the grid short of threads
        assert (block % (32 * big) != 0
                or -(-n // block) * (block // big) < df.FILL_THREADS)


@pytest.mark.parametrize("n,r,rows", [
    (262144, 2, 1024), (1 << 20, 4, 1024), (135168, 1, 1024),
    (134144, 1, 512), (65536, 1, 256), (3001, 1, 128), (1, 1, 128)])
def test_k4_schedule(n, r, rows):
    # K4's rows a CTA: BLOCK while every one of an H100's 132 SMs gets a
    # CTA, halved down to MIN_BLOCK otherwise; R from row_schedule.
    assert pk.SMS == 132
    assert pk.schedule(n) == (r, rows)


@pytest.mark.parametrize("n,block", [(300, 128), (1000, 96), (4096, 512),
                                     (70000, 512), (70001, 256)])
def test_each_row_once_and_one_diagonal_tile(n, block):
    _, rows = df.row_schedule(n, block)
    owned = [i for cta in threads_rows(n, block) for t in cta for i in t]
    assert sorted(owned) == list(range(len(owned)))
    assert len(owned) == -(-n // rows) * rows
    # The self pair of every row of a CTA lies in the CTA's own j tile.
    for c, cta in enumerate(threads_rows(n, block)):
        tiles = {i // rows for t in cta for i in t}
        assert tiles == {c}


@pytest.mark.parametrize("softening,cube,form", [
    (1e-2, True, df.FORM_CUBE), (1e-9, True, df.FORM_CUBE),
    (1e-12, True, df.FORM_CUBE), (1e-13, True, df.FORM_NORMAL),
    (2.0 ** -126, True, df.FORM_NORMAL), (1e-40, True, df.FORM_RSQRTF),
    (0.0, True, df.FORM_RSQRTF), (1e-2, False, df.FORM_NORMAL),
    (1e-40, False, df.FORM_RSQRTF)])
def test_rsqrt_form(softening, cube, form):
    assert df.rsqrt_form(softening, cube=cube) == form


@pytest.mark.parametrize("softening", [1e-2, 1e-13, 2.0 ** -126])
def test_normal_forms_see_no_denormal(softening):
    # Where the host picks rsqrt.approx.ftz, no input is denormal: r2 >=
    # softening (FMA contraction keeps it so) and r2^3 >= softening^3.
    pos, _, _ = _inputs(200, False, seed=1)
    pos[50] = pos[7]  # r2 = softening exactly
    p = torch.from_numpy(pos)
    d = p[None] - p[:, None]
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
          + (d[..., 2] * d[..., 2] + softening))
    x = (r2 * r2) * r2 if df.rsqrt_form(softening) == df.FORM_CUBE else r2
    assert (x >= df.FLT_MIN).all()
    assert torch.equal(rsqrt_model(x, df.FORM_NORMAL), torch.rsqrt(x))


def test_rsqrtf_form_below_flt_min():
    # Below FLT_MIN a coincident pair's r2 is the denormal softening: the
    # host's rsqrtf form keeps its finite term, the ftz form would not.
    pos, _, m = _inputs(64, True, seed=2)
    pos[20] = pos[10]
    soft = 1e-40
    got = pe_model(_t(pos), _t(m), soft, 128)
    want = pk.pe_rows_plain(_t(pos).double(), _t(m).double(), soft)
    assert torch.isfinite(got).all()
    assert torch.allclose(got.double(), want, rtol=1e-5)
    flushed = pe_model(_t(pos), _t(m), soft, 128, form=df.FORM_NORMAL)
    assert torch.isinf(flushed[[10, 20]]).all()


# ---------------------------------------------------------- vs JAX ---

@pytest.mark.parametrize("ni,nj", [(300, 300), (96, 200), (7, 7)])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("softening", [1e-2, 1e-15])
def test_k1_model_vs_jax(ni, nj, masses, softening):
    # 1e-2 takes the fast rsqrt(r2^3) form, 1e-15 rsqrt(r2)^3.
    pi, _, _ = _inputs(ni, False, seed=3)
    pj, _, m = _inputs(nj, masses, seed=4)
    if ni == nj:
        pj = pi
    want = body_force_pallas(_j(pi), _j(pj), _j(m), softening=softening,
                             tile_i=64, tile_j=128, interpret=True)
    got = direct_model(_t(pi), _t(pj), _t(m), softening, 128)
    _close(got, want, FORCE_TOL)


@pytest.mark.parametrize("n,block", [(300, 128), (200, 64)])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("softening", [1e-2, 1e-15])
def test_k5_model_vs_jax(n, block, masses, softening):
    pos, vel, m = _inputs(n, masses, seed=5)
    want = j_fused(_j(pos), _j(vel), _j(m), dt=0.01, softening=softening,
                   tile_i=64, tile_j=128, interpret=True)
    got = fused_model(_t(pos), _t(vel), _t(m), 0.01, softening, block)
    for g, w in zip(got, want):
        _close(g, w, FUSED_TOL)


@pytest.mark.parametrize("n,softening", [(300, 1e-2), (257, 1e-9),
                                         (64, 1e-6)])
@pytest.mark.parametrize("masses", [False, True])
def test_k4_model_vs_jax(n, softening, masses):
    pos, _, m = _inputs(n, masses, seed=6)
    if n == 64:
        pos[20] = pos[10]  # distinct coincident bodies keep their term
    want = float(potential_energy_pallas(_j(pos), _j(m), softening=softening,
                                         tile_i=64, tile_j=128,
                                         interpret=True))
    got = pk.potential_from_rows(pe_model(_t(pos), _t(m), softening, 128),
                                 _t(m)).item()
    assert abs(got - want) <= U_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("block", [64, 128, 256])
def test_models_do_not_depend_on_block(block):
    # One running sum per row in j order: the pads of a larger tile add
    # exact zeros, so every bit is the same at every block.
    pos, _, m = _inputs(300, True, seed=7)
    p, mm = _t(pos), _t(m)
    assert torch.equal(direct_model(p, p, mm, 1e-2, block),
                       direct_model(p, p, mm, 1e-2, 64))
    assert torch.equal(pe_model(p, mm, 1e-2, block),
                       pe_model(p, mm, 1e-2, 64))
