"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips without a CUDA device (decided inside the
fixture, never at import). This file imports neither JAX nor the JAX
package, so it runs on a machine without JAX, with conftest.py (which
imports JAX) left out:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Tolerances are those of chip_smoke.py: K1 and K3 fp32 sums in another
order (rtol 1e-3, atol 1e-4 of the scale), K2 raw sums vs the bf16-mode plain
sums (2e-3 of each column's scale), sym_mxu forces vs a float64 oracle at
the on-card bf16-accumulate bound (rtol 2e-2, atol 5e-3 of the scale), K4's
U within 1e-5 of |U|, and K5 against its plain version at the K1 bound."""

import numpy as np
import pytest
import torch

from mini_nbody_tpu_torch import SimConfig, init, simulate
from mini_nbody_tpu_torch.ops import diagnostics as dg
from mini_nbody_tpu_torch.ops import direct_force as df
from mini_nbody_tpu_torch.ops import pe_kernel as pk
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.ops import symmetric_force as sf
from mini_nbody_tpu_torch.ops.reference import body_force_torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol, atol):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(got).all()
    scale = max(want.abs().max().item(), 1.0)
    assert ((got - want).abs() <= rtol * want.abs() + atol * scale).all()


def _close_cols(got, want, atol=2e-3):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(got).all()
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    assert ((got - want).abs() <= atol * scale).all()


def _pos(n, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)
                            ).to(device)


@pytest.mark.parametrize("ni,nj,masses", [(1, 1, False), (1000, 1000, True),
                                          (4096, 4096, False),
                                          (1000, 3000, True)])
@pytest.mark.parametrize("block", [128, 256, 512])
def test_k1_vs_plain(cuda, ni, nj, masses, block):
    pj = _pos(nj, nj, cuda)
    pi = pj[:ni].contiguous() if ni == nj else _pos(ni, ni + 1, cuda)
    m = torch.rand(nj, device=cuda) + 0.5 if masses else None
    before = df.LAUNCHES
    got = df.body_force_direct(pi, pj, m, block=block)
    assert df.LAUNCHES == before + 1
    _close(got, df.direct_force_plain(pi, pj, m), 1e-3, 1e-4)
    if ni == 1:
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("split_w", [False, True])
def test_k2_tri_vs_bf16_plain(cuda, tile, fold, mask, split_w):
    n, c = 1000, 1024
    p, v = sm._pack(_pos(n, 5, cuda), None, n, c)
    got = sp.build_tri_slot_call(1e-9, tile, c, split_w=split_w,
                                 mask_offdiag=mask, fold=fold)(p, v)
    want = sp.tri_slot_sums_plain(p, v, 1e-9, tile, fold=fold,
                                  mask_offdiag=mask, split_w=split_w,
                                  mma_dtype=torch.bfloat16)
    _close_cols(got.T[:n], want.T[:n])


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("mask", [False, True])
def test_k2_cross_vs_bf16_plain(cuda, tile, mask):
    n, c = 2000, 1024
    mass = torch.rand(n, device=cuda) + 0.5
    p, v = sm._pack(_pos(n, 6, cuda), mass, n, 2 * c)
    before = (sp.LAUNCHES, sp.CROSS_LAUNCHES)
    got = sp.build_cross_slot_call(1e-9, tile, c, mask=mask)(
        p[:c], p[c:], v[:c], v[c:])
    assert (sp.LAUNCHES, sp.CROSS_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = sp.cross_slot_sums_plain(p[:c], p[c:], v[:c], v[c:], 1e-9, tile,
                                    mask=mask, mma_dtype=torch.bfloat16)
    _close_cols(got[0].T, want[0].T)
    _close_cols(got[1].T[:n - c], want[1].T[:n - c])


@pytest.mark.parametrize("masses", [False, True])
def test_sym_mxu_vs_fp64_oracle(cuda, masses):
    n = 3000
    pos = _pos(n, 7, cuda)
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    got = sm.body_force_sym_mxu(pos, m, chunk=1024)
    want = body_force_torch(pos.double(), pos.double(),
                            None if m is None else m.double())
    _close(got, want, 2e-2, 5e-3)


def test_auto_equals_masked_to_tolerance(cuda):
    # Bitwise on the plain path; on the card the atomics sum in another
    # order from run to run, so the two agree to the K2 tolerance.
    pos = _pos(sm.COINCIDENT_AUTO_MIN_N, 8, cuda)
    a = sm.body_force_sym_mxu(pos, coincident="auto")
    b = sm.body_force_sym_mxu(pos, coincident="masked")
    _close(a, b, 1e-3, 1e-4)


def test_duplicates_route_to_masked(cuda):
    cloud = torch.full((sm.COINCIDENT_AUTO_MIN_N, 3), 0.25, device=cuda)
    assert sm.any_coincident(cloud)
    f = sm.body_force_sym_mxu(cloud, coincident="auto")
    assert torch.equal(f, torch.zeros_like(f))


@pytest.mark.parametrize("backend", ["direct", "sym_mxu"])
def test_simulate_goes_through_the_kernels(cuda, backend):
    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = init.uniform_random(n, generator=gen, device=cuda)
    counts = (df.LAUNCHES, sp.LAUNCHES)
    out = simulate(SimConfig(n=n, steps=3, backend=backend, softening=1e-2,
                             integrator="leapfrog", sym_chunk=1024), state)
    torch.cuda.synchronize()
    launched = (df.LAUNCHES - counts[0], sp.LAUNCHES - counts[1])
    # leapfrog: one initial force pass + one per step; sym_mxu at 4 chunks
    # launches 4 tri + 6 cross per pass.
    assert launched == ((4, 0) if backend == "direct" else (0, 40))
    assert torch.isfinite(out.pos).all() and torch.isfinite(out.vel).all()
    ref = simulate(SimConfig(n=n, steps=3, backend="torch", softening=1e-2,
                             integrator="leapfrog"), state)
    _close(out.pos, ref.pos, 1e-2, 1e-3)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_k3_tri_vs_plain(cuda, tile, fold, masses):
    n, c = 1000, 1024
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    p = sf._pack(_pos(n, 9, cuda), m, n, c)
    slots = sp.slot_table(c // tile, fold, False, cuda)
    got, want = torch.zeros((c, 3), device=cuda), torch.zeros((c, 3),
                                                               device=cuda)
    before = (sf.LAUNCHES, sf.CROSS_LAUNCHES)
    sf.symmetric_sums_(got, got, p, p, slots, tile, 1e-9)
    assert (sf.LAUNCHES, sf.CROSS_LAUNCHES) == (before[0] + 1, before[1])
    sf.symmetric_sums_plain(want, want, p, p, slots, tile, 1e-9)
    _close(got, want, 1e-3, 1e-4)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses", [False, True])
def test_k3_cross_vs_plain(cuda, tile, masses):
    n, c = 2000, 1024
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    p = sf._pack(_pos(n, 10, cuda), m, n, 2 * c)
    slots = sp.slot_table(c // tile, False, True, cuda)
    got = [torch.zeros((c, 3), device=cuda) for _ in range(2)]
    want = [torch.zeros((c, 3), device=cuda) for _ in range(2)]
    before = sf.CROSS_LAUNCHES
    sf.symmetric_sums_(*got, p[:c], p[c:], slots, tile, 1e-9)
    assert sf.CROSS_LAUNCHES == before + 1
    sf.symmetric_sums_plain(*want, p[:c], p[c:], slots, tile, 1e-9)
    for g, w in zip(got, want):
        _close(g, w, 1e-3, 1e-4)


@pytest.mark.parametrize("masses", [False, True])
def test_k3_force_and_pair_vs_fp64_oracle(cuda, masses):
    n = 3000
    pos = _pos(n, 11, cuda)
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    m64 = None if m is None else m.double()
    got = sf.body_force_symmetric(pos, m, chunk=1024)
    _close(got, body_force_torch(pos.double(), pos.double(), m64), 1e-3, 1e-4)
    pa, pb = pos[:700], pos[700:2000] + 3.0
    ma, mb = (None, None) if m is None else (m[:700], m[700:2000])
    fa, fb = sf.body_force_pair(pa, pb, ma, mb)
    _close(fa, body_force_torch(pa.double(), pb.double(),
                                None if mb is None else mb.double()),
           1e-3, 1e-4)
    _close(fb, body_force_torch(pb.double(), pa.double(),
                                None if ma is None else ma.double()),
           1e-3, 1e-4)


def test_k3_single_body_and_zero_masses_exactly_zero(cuda):
    pos = _pos(3000, 12, cuda)
    one = sf.body_force_symmetric(pos[:1].contiguous())
    assert torch.equal(one, torch.zeros_like(one))
    inert = sf.body_force_symmetric(pos, torch.zeros(3000, device=cuda),
                                    chunk=1024)
    assert torch.equal(inert, torch.zeros_like(inert))


@pytest.mark.parametrize("n,softening", [(4096, 1e-2), (3001, 1e-9),
                                         (64, 1e-6)])
@pytest.mark.parametrize("masses", [False, True])
def test_k4_vs_plain(cuda, n, softening, masses):
    pos = _pos(n, 13, cuda)
    if n == 64:
        pos[20] = pos[10]  # distinct coincident bodies keep their term
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    before = pk.LAUNCHES
    got = pk.potential_energy_kernel(pos, m, softening).item()
    assert pk.LAUNCHES == before + 1
    want = pk.potential_energy_plain(
        pos.double(), None if m is None else m.double(), softening).item()
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("n,masses", [(1, False), (1000, True),
                                      (4096, False)])
@pytest.mark.parametrize("block", [128, 512])
def test_k5_vs_plain(cuda, n, masses, block):
    pos, vel = _pos(n, 14, cuda), _pos(n, 15, cuda)
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    before = df.FUSED_LAUNCHES
    p2, v2 = df.euler_step_fused(pos, vel, m, dt=1e-3, softening=1e-2,
                                 block=block)
    assert df.FUSED_LAUNCHES == before + 1
    p_ref, v_ref = df.euler_step_fused_plain(pos, vel, m, 1e-3, 1e-2)
    _close(v2, v_ref, 1e-3, 1e-4)
    _close(p2, p_ref, 1e-3, 1e-4)


def test_auto_goes_through_k3_and_total_energy_through_k4(cuda):
    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(1)
    state = init.plummer(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, steps=10, dt=1e-3, softening=1e-2,
                    integrator="leapfrog", use_masses=True, sym_chunk=1024)
    counts = (sf.LAUNCHES, df.LAUNCHES, sp.LAUNCHES, pk.LAUNCHES)
    e0 = dg.total_energy(state, cfg.softening)
    out = simulate(cfg, state)
    e1 = dg.total_energy(out, cfg.softening)
    launched = tuple(a - b for a, b in zip(
        (sf.LAUNCHES, df.LAUNCHES, sp.LAUNCHES, pk.LAUNCHES), counts))
    # 11 force passes of 4 tri + 6 cross launches; two energies.
    assert launched == (110, 0, 0, 2)
    assert dg.energy_drift(e0, e1).item() < 1e-5


def test_fused_simulate_goes_through_k5(cuda):
    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(2)
    state = init.uniform_random(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, steps=5, backend="direct", fused_integrate=True,
                    softening=1e-2)
    counts = (df.FUSED_LAUNCHES, df.LAUNCHES)
    out = simulate(cfg, state)
    assert (df.FUSED_LAUNCHES - counts[0], df.LAUNCHES - counts[1]) == (5, 0)
    ref = simulate(cfg.replace(fused_integrate=False), state)
    _close(out.pos, ref.pos, 1e-4, 1e-5)
    _close(out.vel, ref.vel, 1e-4, 1e-5)
