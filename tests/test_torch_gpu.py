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
U within 1e-5 of |U|, and K5 against its plain version at the K1 bound.
The VJP kernels: B10 and B11 against their plain versions at the K1 bound
(fp32 sums in another order); B13 and B14 raw sums against
their bf16-mode plain sums at K2's per-column bound, and B13's gradient
against the fp32 B11 at the sym_mxu bound (rtol 2e-2, atol 5e-3). B6
(the mxu backend) and B4 (body_force_pair_mxu on K2's cross mode): raw sums
against their bf16-mode plain sums at K2's per-column bound, the fp32 mode
of B6 against a float64 oracle at the K1 bound, and B6's auto and fast runs
bitwise equal to its masked run (no atomics).

The ensemble VJPs B9c (B11 per system) and B9d (B13 per system): each
system bitwise its standalone VJP at the same tile, raw sums against the
plain versions with the system axis (B9c at the K1 bound, B9d at K2's
per-column bound against the bf16-mode plain sums), and no gradient leaks
from one system into another. The resident kernel B15: a trajectory against
its plain version (the bf16 class against the bf16-mode one), the change of
each velocity and position within RES_PLAIN of its own scale (chip_smoke.py's
limits), each ensemble system bitwise its standalone run, two runs and a
split Yoshida-4 phase bitwise one run, 'auto' bitwise 'masked', a 'fast'
fold over pads within the class bound of 'masked' (tests/test_resident_sym.py:
rtol 1e-4, atol 1e-5 of the scale in the fp32 class, 2e-2 and 2e-3 in the
bf16 class), and simulate's resident route, forced or by default, bitwise
the streamed loop: a routed leapfrog or Yoshida-4 simulate and
simulate_ensemble call is one B15 launch with no streamed force launch and
no slot_reduce, the parameter sweep too, a run of many pieces bitwise the
streamed Euler, leapfrog and Yoshida-4 runs; B15's occupancy (no spills
and at least 2 CTAs per SM in the fp32 class, the bf16 class's two
instantiations no fewer CTAs per SM than K2).

B16 (the band traversal) against its plain version in bf16 mode in its
tri, cross and ensemble modes at the bf16 class per column (rtol 2e-2,
atol 5e-3 of the column's scale), one launch and one reduce per call, each
call twice bitwise; 'auto' and 'fast' bitwise 'masked', each band ensemble
system bitwise its standalone call, and simulate on the band through B16
alone.

B12 (vjp_pos_pair, the 2-D grid backward) against its plain version at the
K1 bound, with sets that share bodies, coincident bodies off the
diagonal, pairs whose d2 underflows to 0 (masked) or is a denormal (not),
pads inside a micro-tile and several pieces of slots, one launch and one slot_reduce per piece, two calls bitwise equal;
its registers, spills and CTAs per SM. slot_reduce bitwise its plain
version at widths 3, 4 and 8, tiles 64 and 128, lists of 1 to 2049 tiles
and one or three systems, and refused on misaligned operands. The
sharded path on a one-rank NCCL group: every comm bitwise the single-card
run on its shard's kernel, and the grid's gradient through B12 within the
fp32 class of the single-card B10 gradient (rtol 1e-3, atol 1e-4 of its
scale).

K3's and K2's register bodies one slot at a time: a DIAG, a CROSS and a
FOLD slot at tiles 64 and 128, with a ragged tail whose pads start inside
a micro-tile or fragment and coincident off-diagonal pairs, each partial
tile against the plain version's under the K3 bound and K2's per-column
bound, the rest of the accumulators exactly zero.

The pair-once slot kernels K2, K3, B11 and B13 sum in a fixed order: two
runs are bitwise equal, 'auto' and 'fast' are bitwise 'masked', a
checkpointed rollout gradient is bitwise the unchecked one, and every system
of an ensemble (B9a on K2, B9b on K3) is bitwise its standalone call. B14
against its bf16-mode plain version with 131,072 sources per row. The
card's VJP route: B13 at config 3's N through make_differentiable_force,
within the bf16 class of B14, twice bitwise, with no duplicate scan; the
pair-once VJPs on both sides of JAX's _SYM_BWD_MAX, lowered.

The ordered VJPs' register designs: B14 at tiles 64 and 128 and B10 at
blocks 32 to 1024, ragged, twice bitwise and 'fast' bitwise 'masked' on
duplicate-free bodies, against their plain versions at the bounds above;
their registers, spills and CTAs per SM from their occupancy queries.

The pair-once VJPs' persistent register bodies, B11 (fp32 micro-tiles) and
B13 (w and c in mma.sync fragments), at every instantiation (tile 64 and
128; unit masses, masses, the mass cotangent): a whole chunked call at a
ragged N whose CTAs each walk several slots against the plain version,
masked and maskless; one DIAG, CROSS or FOLD slot alone with coincident
pairs, the rest of the accumulators exactly zero; two runs bitwise and
'fast' bitwise 'masked'; 7 ensemble systems in one launch (7 divides no
persistent width) each bitwise its standalone call; and no spills at the
warps per SM each is compiled for, from vjp_sym_info and vjp_mxu_info.

K1, K5 and K4 on their row schedule (R rows a thread, rows a CTA): K1's
forces and K4's row sums bitwise equal at blocks 128, 256 and 512 and at
every R a launch can take, ragged n included, in each rsqrt form (K1's
rsqrtf form on a rectangle of disjoint sets, where no self pair overflows);
K5's (pos', vel') bitwise K1's force followed by PyTorch's v + dt F, p + dt
v'; K4 below FLT_MIN (the rsqrtf instantiation) with a coincident pair
against its fp64 plain version within 1e-5 of |U|; the rsqrt.approx.ftz
forms refused where the softening does not make them exact; no spills."""

import numpy as np
import pytest
import torch

from mini_nbody_tpu_torch import (BodyState, SimConfig, init,
                                  make_differentiable_ensemble_force,
                                  make_differentiable_force, make_rollout_fn,
                                  simulate, simulate_ensemble)
from mini_nbody_tpu_torch.ops import diagnostics as dg
from mini_nbody_tpu_torch.ops import direct_force as df
from mini_nbody_tpu_torch.ops import mxu_force as mf
from mini_nbody_tpu_torch.ops import pe_kernel as pk
from mini_nbody_tpu_torch.ops import resident_sym as rs
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.ops import symmetric_force as sf
from mini_nbody_tpu_torch.ops import vjp_kernel as vk
from mini_nbody_tpu_torch.ops import vjp_mxu as vm
from mini_nbody_tpu_torch.sim import init_carry
from mini_nbody_tpu_torch.ops.reference import body_force_torch
from mini_nbody_tpu_torch.utils import tracing

pytestmark = pytest.mark.gpu


def _count(name):
    """The registry's launch count of ``name`` (utils/tracing.counters); a
    kernel's name without a mode, such as "launch.K2", sums its modes."""
    return sum(v for k, v in tracing.counters().items()
               if k == name or k.startswith(name + "."))


def _counts(*names):
    """_count of each name, as a tuple."""
    return tuple(_count(n) for n in names)


def _launched(before, *names):
    """_counts(*names) less ``before``, what they were at an earlier
    point."""
    return tuple(a - b for a, b in zip(_counts(*names), before))


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
    before = _count("launch.K1")
    got = df.body_force_direct(pi, pj, m, block=block)
    assert _count("launch.K1") == before + 1
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
    before = _counts("launch.K2", "launch.K2.cross")
    got = sp.build_cross_slot_call(1e-9, tile, c, mask=mask)(
        p[:c], p[c:], v[:c], v[c:])
    assert _launched(before, "launch.K2", "launch.K2.cross") == (1, 1)
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


def test_auto_equals_masked_to_tolerance(cuda, monkeypatch):
    # The bitwise contract is test_sym_mxu_auto_and_fast_bitwise_masked.
    # K2's gate at 8192, so 'auto' runs the duplicate scan.
    monkeypatch.setattr(sm, "COINCIDENT_AUTO_MIN_N", 8192)
    pos = _pos(8192, 8, cuda)
    a = sm.body_force_sym_mxu(pos, coincident="auto")
    b = sm.body_force_sym_mxu(pos, coincident="masked")
    _close(a, b, 1e-3, 1e-4)


def test_duplicates_route_to_masked(cuda, monkeypatch):
    monkeypatch.setattr(sm, "COINCIDENT_AUTO_MIN_N", 8192)
    cloud = torch.full((8192, 3), 0.25, device=cuda)
    assert sm.any_coincident(cloud)
    f = sm.body_force_sym_mxu(cloud, coincident="auto")
    assert torch.equal(f, torch.zeros_like(f))


@pytest.mark.parametrize("backend", ["direct", "sym_mxu"])
def test_simulate_goes_through_the_kernels(cuda, backend):
    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = init.uniform_random(n, generator=gen, device=cuda)
    counts = _counts("launch.K1", "launch.K2")
    out = simulate(SimConfig(n=n, steps=3, backend=backend, softening=1e-2,
                             integrator="leapfrog", sym_chunk=1024), state)
    torch.cuda.synchronize()
    launched = _launched(counts, "launch.K1", "launch.K2")
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
    before = _counts("launch.K3", "launch.K3.cross")
    sf.symmetric_sums_(got, got, p, p, slots, tile, 1e-9)
    assert _launched(before, "launch.K3", "launch.K3.cross") == (1, 0)
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
    before = _count("launch.K3.cross")
    sf.symmetric_sums_(*got, p[:c], p[c:], slots, tile, 1e-9)
    assert _count("launch.K3.cross") == before + 1
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


# One slot of each kind over four blocks: (kind, bi, bj), each touching the
# last block, which holds the ragged tail (3 T + 37 real bodies: the pads
# start inside a register micro-tile of K3 and a 16-row fragment of K2).
ONE_SLOT = {"diag": (sp.SLOT_DIAG, 3, 3), "cross": (sp.SLOT_CROSS, 1, 3),
            "fold": (sp.SLOT_FOLD, 2, 3)}


def _one_slot_case(tile, seed, device, masses):
    """Positions of 3 tile + 37 bodies with coincident off-diagonal pairs in
    each slot of ONE_SLOT (two distinct bodies at one point), and masses."""
    n = 3 * tile + 37
    pos = _pos(n, seed, device)
    t = tile
    pos[3 * t + 5] = pos[t + 5]        # cross (1, 3): rows vs columns
    pos[3 * t + 9] = pos[3 * t + 2]    # diag (3, 3)
    pos[2 * t + 9] = pos[2 * t + 3]    # fold, side a's triangle
    pos[3 * t + 7] = pos[3 * t + 1]    # fold, side b's triangle
    m = torch.rand(n, device=device) + 0.5 if masses else None
    return n, pos, m


def _side_tiles(kind, bi, bj, tile, acc_a, acc_b, real):
    """The slot's two partial tiles as they land in the accumulators (a
    DIAG slot has side 0 only), real rows only, and the rest of both
    accumulators, which one slot leaves at zero."""
    sides = [acc_a[bi * tile:(bi + 1) * tile]]
    if kind != sp.SLOT_DIAG:
        sides.append(acc_b[bj * tile:(bj + 1) * tile])
    rest = [acc_a[:bi * tile], acc_b[(bj + 1) * tile:]]
    if kind == sp.SLOT_CROSS:
        rest += [acc_a[(bi + 1) * tile:], acc_b[:bj * tile]]
    else:
        rest.append(acc_a[(bi + 1) * tile:bj * tile])
    keep = [min(tile, max(0, real - b * tile)) for b in (bi, bj)]
    return [s[:k] for s, k in zip(sides, keep)], rest


@pytest.mark.parametrize("which", sorted(ONE_SLOT))
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("softening", [1e-2, 1e-13])
def test_k3_one_slot_vs_plain(cuda, which, tile, masses, softening):
    # softening 1e-13 takes rsqrt(r2)^3, 1e-2 rsqrt(r2^3); coincident pairs
    # have d = 0 and add exactly zero either way.
    kind, bi, bj = ONE_SLOT[which]
    n, pos, m = _one_slot_case(tile, 70, cuda, masses)
    p = sf._pack(pos, m, n, 4 * tile)
    cross = kind == sp.SLOT_CROSS
    slots = torch.tensor([[kind, bi, bj]], dtype=torch.int32, device=cuda)
    got = [torch.zeros((4 * tile, 3), device=cuda) for _ in range(1 + cross)]
    want = [torch.zeros_like(got[0]) for _ in range(1 + cross)]
    sf.symmetric_sums_(got[0], got[-1], p, p, slots, tile, softening)
    sf.symmetric_sums_plain(want[0], want[-1], p, p, slots, tile, softening)
    tiles, rest = _side_tiles(kind, bi, bj, tile, got[0], got[-1], n)
    want_tiles, _ = _side_tiles(kind, bi, bj, tile, want[0], want[-1], n)
    for g, w in zip(tiles, want_tiles):
        _close(g, w, 1e-3, 1e-4)
    for r in rest:
        assert torch.equal(r, torch.zeros_like(r))


@pytest.mark.parametrize("which", sorted(ONE_SLOT))
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("split_w", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("softening", [1e-2, 1e-13])
def test_k2_one_slot_vs_bf16_plain(cuda, which, tile, masses, split_w, mask,
                                   softening):
    # Each partial tile against the bf16-mode plain version's, per column
    # scale; unmasked coincident pairs get w = softening^-1.5 in both.
    kind, bi, bj = ONE_SLOT[which]
    n, pos, m = _one_slot_case(tile, 71, cuda, masses)
    p, v = sm._pack(pos, m, n, 4 * tile)
    slots = torch.tensor([[kind, bi, bj]], dtype=torch.int32, device=cuda)
    got = [torch.zeros((4 * tile, 8), device=cuda) for _ in range(2)]
    want = [torch.zeros_like(got[0]) for _ in range(2)]
    if kind == sp.SLOT_CROSS:
        sp.cross_slot_sums_(*got, p, p, v, v, slots, tile, softening,
                            split_w, mask)
    else:
        got[1] = got[0]
        want[1] = want[0]
        sp.tri_slot_sums_(got[0], p, v, slots, tile, softening, split_w,
                          mask)
    sp._slot_sums_plain(*want, p, p, v, v, slots, tile, softening, split_w,
                        mask, mma_dtype=torch.bfloat16)
    tiles, rest = _side_tiles(kind, bi, bj, tile, *got, n)
    want_tiles, _ = _side_tiles(kind, bi, bj, tile, *want, n)
    for g, w in zip(tiles, want_tiles):
        _close_cols(g, w)
    for r in rest:
        assert torch.equal(r, torch.zeros_like(r))


@pytest.mark.parametrize("n,softening", [(4096, 1e-2), (3001, 1e-9),
                                         (64, 1e-6)])
@pytest.mark.parametrize("masses", [False, True])
def test_k4_vs_plain(cuda, n, softening, masses):
    pos = _pos(n, 13, cuda)
    if n == 64:
        pos[20] = pos[10]  # distinct coincident bodies keep their term
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    before = _count("launch.K4")
    got = pk.potential_energy_kernel(pos, m, softening).item()
    assert _count("launch.K4") == before + 1
    want = pk.potential_energy_plain(
        pos.double(), None if m is None else m.double(), softening).item()
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("n,masses", [(1, False), (1000, True),
                                      (4096, False)])
@pytest.mark.parametrize("block", [128, 512])
def test_k5_vs_plain(cuda, n, masses, block):
    pos, vel = _pos(n, 14, cuda), _pos(n, 15, cuda)
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    before = _count("launch.K5")
    p2, v2 = df.euler_step_fused(pos, vel, m, dt=1e-3, softening=1e-2,
                                 block=block)
    assert _count("launch.K5") == before + 1
    p_ref, v_ref = df.euler_step_fused_plain(pos, vel, m, 1e-3, 1e-2)
    _close(v2, v_ref, 1e-3, 1e-4)
    _close(p2, p_ref, 1e-3, 1e-4)


def test_auto_goes_through_k3_and_total_energy_through_k4(cuda):
    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(1)
    state = init.plummer(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, steps=10, dt=1e-3, softening=1e-2,
                    integrator="leapfrog", use_masses=True, sym_chunk=1024)
    counts = _counts("launch.K3", "launch.K1", "launch.K2", "launch.K4")
    e0 = dg.total_energy(state, cfg.softening)
    out = simulate(cfg, state)
    e1 = dg.total_energy(out, cfg.softening)
    launched = tuple(a - b for a, b in zip(
        _counts("launch.K3", "launch.K1", "launch.K2", "launch.K4"), counts))
    # 11 force passes of 4 tri + 6 cross launches; two energies.
    assert launched == (110, 0, 0, 2)
    assert dg.energy_drift(e0, e1).item() < 1e-5


def test_fused_simulate_goes_through_k5(cuda):
    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(2)
    state = init.uniform_random(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, steps=5, backend="direct", fused_integrate=True,
                    softening=1e-2)
    counts = _counts("launch.K5", "launch.K1")
    out = simulate(cfg, state)
    assert _launched(counts, "launch.K5", "launch.K1") == (5, 0)
    ref = simulate(cfg.replace(fused_integrate=False), state)
    _close(out.pos, ref.pos, 1e-4, 1e-5)
    _close(out.vel, ref.vel, 1e-4, 1e-5)


def _vjp_case(n, seed, masses, device, coincident=False):
    pos = _pos(n, seed, device)
    if coincident:
        pos[200] = pos[3]  # two distinct bodies at one point
    g = _pos(n, seed + 1, device)
    m = torch.rand(n, device=device) + 0.5 if masses else None
    return pos, g, m


@pytest.mark.parametrize("n,masses,softening,coincident", [
    (1000, False, 1e-2, "auto"), (1000, True, 1e-2, "fast"),
    (3001, False, 1e-9, "auto"), (3001, True, 1e-9, "masked")])
@pytest.mark.parametrize("block", [128, 256])
def test_b10_vs_plain(cuda, n, masses, softening, coincident, block):
    # At softening 1e-9 two distinct bodies share a position ('fast'
    # promises there are none).
    pos, g, m = _vjp_case(n, 20, masses, cuda, softening == 1e-9)
    before = _count("launch.B10")
    got = vk.vjp_pos_direct(pos, g, m, softening, block=block,
                            coincident=coincident)
    assert _count("launch.B10") == before + 1
    _close(got, vk.vjp_ordered_plain(pos, g, pos, g, m, m, softening),
           1e-3, 1e-4)
    rect = vk.vjp_pos_rect(pos[:700].contiguous(), g[:700].contiguous(), pos,
                           g, None if m is None else m[:700].contiguous(), m,
                           softening, block)
    _close(rect, got[:700], 1e-3, 1e-4)


@pytest.mark.parametrize("na,nb,shared", [(1000, 3001, True),
                                          (3001, 1000, False),
                                          (4096, 4096, True),
                                          (130, 69, True), (1, 1, True),
                                          (3001, 9001, "apart"),
                                          (300, 200, "tiny")])
@pytest.mark.parametrize("masses", [False, True])
def test_b12_vs_plain(cuda, na, nb, shared, masses, monkeypatch):
    # A grid tile: a's first half of its bodies are also b's last ones
    # (True), or a few of a's bodies sit at other indices of b ("apart":
    # coincident pairs off the diagonal of every tile), or ("tiny") two of
    # a's bodies lie 1e-24 and 1e-20 from one of b's: the first pair's d2
    # underflows to 0 and is masked, the second's is a denormal and is not.
    # Pads start inside a micro-tile (130 = 128 + 2 rows, 69 columns);
    # 3001 x 9001 takes several pieces at PIECE_SLOTS = 2^10. One launch and
    # one slot_reduce per piece; two calls bitwise.
    monkeypatch.setattr(sp, "PIECE_SLOTS", 1 << 10)
    pos_a, g, m_a = _vjp_case(na, 21, masses, cuda, False)
    pos_b, _, m_b = _vjp_case(nb, 22, masses, cuda, False)
    if shared == "apart":
        for i, j in ((3, 4000), (2999, 17), (1500, 9000)):
            pos_b[j] = pos_a[i]
    elif shared == "tiny":
        pos_b[150] = 0.0
        pos_a[7] = pos_a.new_tensor([1e-24, 0.0, 0.0])
        pos_a[250] = pos_a.new_tensor([0.0, -1e-20, 0.0])
    elif shared:
        k = max(1, min(na, nb) // 2)
        pos_b[nb - k:] = pos_a[:k]
        if masses:
            m_b[nb - k:] = m_a[:k]
    tile = vk.PAIR_TILE
    pieces = -(-(-(-na // tile) * -(-nb // tile)) // sp.PIECE_SLOTS)
    before = _counts("launch.B12", "launch.slot_reduce")
    got = vk.vjp_pos_pair(pos_a, g, pos_b, m_a, m_b, 1e-2)
    assert _launched(before, "launch.B12", "launch.slot_reduce") == (
        pieces, pieces)
    again = vk.vjp_pos_pair(pos_a, g, pos_b, m_a, m_b, 1e-2)
    want = vk.vjp_pos_pair_plain(pos_a, g, pos_b, m_a, m_b, 1e-2)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _close(a, w, 1e-3, 1e-4)


@pytest.mark.parametrize("masses", [0, 1])
def test_b12_registers_without_spills(cuda, masses):
    # 4 x 16 micro-tiles at tile 128: 256 threads at 16 warps per SM (at
    # most 128 registers), no local memory.
    regs, local, ctas, threads = _occupancy("vjp_pair_info", masses,
                                            threads=True)
    tile = vk.PAIR_TILE
    assert threads == (tile // 4) * (tile // 16)
    assert regs <= 128 and local == 0 and ctas * threads // 32 >= 16


@pytest.fixture
def nccl_one_rank(cuda, tmp_path):
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0, device_id=dev)
    yield dev
    dist.destroy_process_group()


@pytest.mark.parametrize("comm,backend,shape,single", [
    ("all_gather", "auto", (1,), "direct"), ("ring", "auto", (1,), "sym"),
    ("ring_sym", "sym", (1,), "sym"), ("grid", "direct", (1, 1), "direct")])
def test_sharded_one_rank_is_bitwise_the_card(nccl_one_rank, comm, backend,
                                              shape, single):
    from mini_nbody_tpu_torch import make_mesh, simulate_sharded

    dev = nccl_one_rank
    s = init.plummer(3000, generator=torch.Generator(device=dev)
                     .manual_seed(23), device=dev)
    cfg = SimConfig(n=3000, steps=2, dt=1e-3, softening=1e-2,
                    integrator="leapfrog", use_masses=True, backend=backend,
                    comm=comm, mesh_shape=shape)
    out = simulate_sharded(cfg, make_mesh(shape), s)
    ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather",
                               backend=single, resident=False), s)
    assert torch.equal(out.pos, ref.pos) and torch.equal(out.vel, ref.vel)


def test_sharded_grid_gradient_goes_through_b12(nccl_one_rank):
    from mini_nbody_tpu_torch import make_mesh
    from mini_nbody_tpu_torch.parallel.sharded import (make_sharded_step_fn,
                                                       shard_state)
    from mini_nbody_tpu_torch.sim import make_step_fn

    dev = nccl_one_rank
    n = 3000
    s = init.plummer(n, generator=torch.Generator(device=dev)
                     .manual_seed(24), device=dev)
    cfg = SimConfig(n=n, dt=1e-3, softening=1e-2, use_masses=True,
                    backend="direct", comm="grid", mesh_shape=(1, 1))

    def grad(step, st):
        p = st.pos.clone().requires_grad_(True)
        carry = (BodyState(pos=p, vel=st.vel, mass=st.mass),
                 torch.zeros_like(p))
        for _ in range(2):
            carry = step(carry)
        (carry[0].vel ** 2).sum().backward()
        return p.grad

    before = _count("launch.B12")
    got = grad(make_sharded_step_fn(cfg, make_mesh((1, 1)),
                                    differentiable=True),
               shard_state(s, make_mesh((1, 1))))
    # one per backward pass: 3000^2 at tile 128 is one piece of slots
    assert _count("launch.B12") == before + 2
    want = grad(make_step_fn(cfg.replace(mesh_shape=None, comm="all_gather",
                                         backend="auto"),
                             differentiable=True), s)
    scale = want.abs().max().item()
    assert ((got - want).abs() <= 1e-3 * want.abs() + 1e-4 * scale).all()


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses,mass_grad", [(False, False), (True, False),
                                              (True, True)])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_b11_tri_vs_plain(cuda, tile, masses, mass_grad, fold, mask):
    n, c = 1000, 1024
    pos, g, m = _vjp_case(n, 21, masses, cuda)
    p = sf._pack(pos, m, n, c)
    gp = vk._pad_rows(g, c)
    slots = sp.slot_table(c // tile, fold, False, cuda)
    ko = 4 if mass_grad else 3
    got, want = (torch.zeros((c, ko), device=cuda) for _ in range(2))
    before = _counts("launch.B11", "launch.B11.cross")
    vk.vjp_sym_sums_(got, got, p, p, gp, gp, slots, tile, 1e-9, mask)
    assert _counts("launch.B11", "launch.B11.cross") == (before[0] + 1,
                                                         before[1])
    vk.vjp_sym_sums_plain(want, want, p, p, gp, gp, slots, tile, 1e-9, mask)
    _close(got[:n], want[:n], 1e-3, 1e-4)


@pytest.mark.parametrize("masses,mass_grad", [(False, False), (True, True)])
def test_b11_cross_and_whole_vs_plain(cuda, masses, mass_grad):
    n, c, tile = 2000, 1024, 64
    pos, g, m = _vjp_case(n, 22, masses, cuda)
    p = sf._pack(pos, m, n, 2 * c)
    gp = vk._pad_rows(g, 2 * c)
    slots = sp.slot_table(c // tile, False, True, cuda)
    ko = 4 if mass_grad else 3
    got = [torch.zeros((c, ko), device=cuda) for _ in range(2)]
    want = [torch.zeros((c, ko), device=cuda) for _ in range(2)]
    vk.vjp_sym_sums_(*got, p[:c], p[c:], gp[:c], gp[c:], slots, tile, 1e-2)
    vk.vjp_sym_sums_plain(*want, p[:c], p[c:], gp[:c], gp[c:], slots, tile,
                          1e-2, True)
    for a, b in zip(got, want):
        _close(a, b, 1e-3, 1e-4)
    # The whole backward over three chunks against the ordered plain VJP.
    out = vk.vjp_pos_sym(pos, g, m, 1e-2, chunk=768, mass_grad=mass_grad)
    pos_bar = out[0] if mass_grad else out
    _close(pos_bar, vk.vjp_ordered_plain(pos, g, pos, g, m, m, 1e-2),
           1e-3, 1e-4)


def _mxu_sums(p, gp, q, slots, tile, ko, mask, kernel):
    acc = torch.zeros((p.shape[0], ko), device=p.device)
    if kernel:
        vm.vjp_mxu_sums_(acc, acc, p, p, gp, gp, q, q, slots, tile, 1e-9,
                         mask)
    else:
        vm.vjp_mxu_sums_plain(acc, acc, p, p, gp, gp, q, q, slots, tile, 1e-9,
                              mask, mma_dtype=torch.bfloat16)
    return acc


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses,mass_grad", [(False, False), (True, False),
                                              (True, True)])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_b13_tri_vs_bf16_plain(cuda, tile, masses, mass_grad, fold, mask):
    n = 1000
    pos, g, m = _vjp_case(n, 23, masses, cuda)
    (_, c, _, _), (p, gp, q) = vm.sums_inputs(pos, g, m, tile, chunk=1024)
    slots = sp.slot_table(c // tile, fold, False, cuda)
    ko = 9 if mass_grad else 8
    before = _count("launch.B13")
    got = _mxu_sums(p, gp, q, slots, tile, ko, mask, True)
    assert _count("launch.B13") == before + 1
    want = _mxu_sums(p, gp, q, slots, tile, ko, mask, False)
    _close_cols(got[:n], want[:n])


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("softening", [1e-2, 1e-9])
def test_b13_vs_fp32_b11(cuda, masses, softening):
    pos, g, m = _vjp_case(3001, 24, masses, cuda, softening == 1e-9)
    got = vm.vjp_pos_sym_mxu(pos, g, m, softening, chunk=1024)
    want = vk.vjp_pos_sym(pos, g, m, softening, chunk=1024)
    _close(got, want, 2e-2, 5e-3)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("square", [False, True])
def test_b14_vs_bf16_plain(cuda, tile, masses, square):
    pos, g, m = _vjp_case(3001, 25, masses, cuda)
    k = 3001 if square else 900
    pk_, gk_ = pos[:k].contiguous(), g[:k].contiguous()
    mk = None if m is None else m[:k].contiguous()
    before = _count("launch.B14")
    got = vm.vjp_rect_mxu_rows(
        pk_, gk_, pos, g, mk, m, 1e-9, tile,
        square_coincident="auto" if square else None)
    assert _count("launch.B14") == before + 1
    want = vm.vjp_rect_mxu_plain(pk_, gk_, pos, g, mk, m, 1e-9,
                                 mma_dtype=torch.bfloat16)
    _close_cols(got, want)
    full = vm.vjp_rect_mxu(pos, g, pos, g, m, m, 1e-9, tile, "auto")
    _close(full, vk.vjp_pos_sym(pos, g, m, 1e-9), 2e-2, 5e-3)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("n", [1, 17, 3001, 8193])
def test_b14_reruns_bitwise(cuda, tile, masses, square, n):
    # B14's register design (one 16-row strip per warp, w and c packed
    # straight into mma.sync fragments, a fresh fragment per j tile): two
    # runs give the same bits, square calls under 'fast' those of 'masked'
    # (no two distinct bodies coincide), and the rows stay in the bf16
    # class of the plain sums per column. n = 1 and 17 leave one ragged
    # tile; 3001 and 8193 a ragged last k and j tile.
    pos, g, m = _vjp_case(n, 48, masses, cuda)
    k = n if square else max(1, n // 3)
    pk_, gk_ = pos[:k].contiguous(), g[:k].contiguous()
    mk = None if m is None else m[:k].contiguous()
    args = (pk_, gk_, pos, g, mk, m, 1e-2, tile)
    got = vm.vjp_rect_mxu_rows(*args, "fast" if square else None)
    assert torch.equal(got, vm.vjp_rect_mxu_rows(
        *args, "fast" if square else None))
    if square:
        assert torch.equal(got, vm.vjp_rect_mxu_rows(*args, "masked"))
    _close_cols(got, vm.vjp_rect_mxu_plain(pk_, gk_, pos, g, mk, m, 1e-2,
                                           mma_dtype=torch.bfloat16))


@pytest.mark.parametrize("block", [32, 64, 512, 1024])
@pytest.mark.parametrize("masses", [False, True])
def test_b10_micro_tiles_rerun_bitwise(cuda, block, masses):
    # B10's register micro-tiles (4 receivers a thread at 512 and 1024, 2 at
    # 64, 1 at 32): 3001 receivers leave a ragged last block and micro-tile.
    # Two runs give the same bits, 'fast' those of 'masked', and the rows
    # stay at the K1 bound of the plain version.
    pos, g, m = _vjp_case(3001, 49, masses, cuda)
    got = vk.vjp_pos_direct(pos, g, m, 1e-2, block=block, coincident="fast")
    assert torch.equal(got, vk.vjp_pos_direct(pos, g, m, 1e-2, block=block,
                                              coincident="fast"))
    assert torch.equal(got, vk.vjp_pos_direct(pos, g, m, 1e-2, block=block,
                                              coincident="masked"))
    _close(got, vk.vjp_ordered_plain(pos, g, pos, g, m, m, 1e-2), 1e-3, 1e-4)


def test_kernels_refuse_inputs_that_require_grad(cuda):
    pos = _pos(256, 26, cuda).requires_grad_(True)
    with pytest.raises(RuntimeError, match="make_differentiable_force"):
        df.body_force_direct(pos, pos)
    with pytest.raises(RuntimeError, match="make_differentiable_force"):
        sf.body_force_symmetric(pos)
    with pytest.raises(RuntimeError, match="make_differentiable_force"):
        sm.body_force_sym_mxu(pos)
    with pytest.raises(RuntimeError, match="make_differentiable_force"):
        pk.potential_energy_kernel(pos)
    with torch.no_grad():
        df.body_force_direct(pos, pos)  # no graph, no refusal


@pytest.mark.parametrize("backend", ["sym", "sym_mxu", "direct"])
@pytest.mark.parametrize("n", [3000, 5000])
def test_grad_goes_through_the_vjp_kernels(cuda, monkeypatch, backend, n):
    # JAX's _SYM_BWD_MAX lowered to 4096: on the card n = 3000 and n = 5000
    # alike take the pair-once backward of the class (B11, B13), never the
    # ordered ones (B10, B14), which their own tests hold.
    from mini_nbody_tpu_torch.ops import autodiff

    monkeypatch.setattr(autodiff, "_SYM_BWD_MAX", 4096)
    pos, _, m = _vjp_case(n, 27, True, cuda)
    cfg = SimConfig(n=n, backend=backend, softening=1e-2, use_masses=True,
                    sym_chunk=2048)
    force = make_differentiable_force(cfg)
    counts = _counts("launch.B10", "launch.B11", "launch.B13", "launch.B14")
    p = pos.clone().requires_grad_(True)
    (force(p, m) ** 2).sum().backward()
    launched = [a - b for a, b in zip(
        _counts("launch.B10", "launch.B11", "launch.B13", "launch.B14"),
        counts)]
    bf16 = backend == "sym_mxu"
    assert launched == [0, int(not bf16), int(bf16), 0]
    g = 2.0 * force(pos, m).detach()
    ref = vk.vjp_ordered_plain(pos, g, pos, g, m, m, 1e-2)
    _close(p.grad, ref, *((2e-2, 5e-3) if bf16 else (1e-3, 1e-4)))


def test_b13_takes_config3s_n_on_the_card(cuda):
    # Beyond JAX's _SYM_BWD_MAX the card keeps the pair-once B13: at config
    # 3's N with Plummer masses, make_differentiable_force's gradient is B13's, within
    # the bf16 class of B14 called square as the ordered route called it,
    # bitwise on a second run, and no duplicate scan runs.
    n = 262144
    gen = torch.Generator(device=cuda).manual_seed(31)
    s = init.plummer(n, generator=gen, device=cuda)
    g = torch.randn((n, 3), generator=gen, device=cuda)
    force = make_differentiable_force(SimConfig(
        n=n, backend="sym_mxu", softening=1e-2, use_masses=True))

    def grad():
        p = s.pos.clone().requires_grad_(True)
        force(p, s.mass).backward(g)
        return p.grad

    names = ("route.vjp.B13", "route.vjp.B14", "launch.B14",
             "coincident.scan")
    before = _counts(*names)
    first = grad()
    assert _launched(before, *names) == (1, 0, 0, 0)
    assert torch.equal(first, grad())
    want = vm.vjp_rect_mxu(s.pos, g, s.pos, g, s.mass, s.mass, 1e-2)
    _close(first, want, 2e-2, 5e-3)


def test_rollout_sqrt_matches_none_on_the_card(cuda):
    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(3)
    s = init.plummer(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, dt=1e-3, softening=1e-2, integrator="leapfrog",
                    use_masses=True)
    carry0 = init_carry(cfg, s)
    grads = {}
    for remat in ("none", "sqrt"):
        p = s.pos.clone().requires_grad_(True)
        st = BodyState(pos=p, vel=s.vel, mass=s.mass)
        out, _ = make_rollout_fn(cfg, 10, remat)((st, carry0[1]))
        (out.pos ** 2).sum().backward()
        grads[remat] = p.grad
    # A tolerance; test_rollout_remat_bitwise holds the bits.
    _close(grads["sqrt"], grads["none"], 1e-4, 1e-5)


def test_sqrt_rollout_launch_counts(cuda):
    # A 10-step "sqrt" rollout at n = 4096 on auto (K3, chunk 2048: 2 tri +
    # 1 cross launches per pass): 10 forward passes, 9 recomputed in the
    # backward (3 checkpointed segments of 3 steps; the last step is
    # outside them), and one B11 launch per step's force but the last: it
    # feeds only the final velocity and acceleration, which the loss does
    # not read.
    n, steps = 4096, 10
    gen = torch.Generator(device=cuda).manual_seed(4)
    s = init.plummer(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, dt=1e-3, softening=1e-2, integrator="leapfrog",
                    use_masses=True, sym_chunk=2048)
    carry0 = init_carry(cfg, s)
    counts = _counts("launch.K3", "launch.K3.cross", "launch.B11")
    p = s.pos.clone().requires_grad_(True)
    out, _ = make_rollout_fn(cfg, steps)((BodyState(pos=p, vel=s.vel,
                                                    mass=s.mass), carry0[1]))
    (out.pos ** 2).sum().backward()
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(
        _counts("launch.K3", "launch.K3.cross", "launch.B11"), counts)]
    assert launched == [3 * 19, 19, 9]
    assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0


def _b6_case(n, seed, masses, device, coincident):
    pos, _, m = _vjp_case(n, seed, masses, device, coincident)
    return pos, m


@pytest.mark.parametrize("n,masses,softening,mode", [
    (3001, False, 1e-2, "auto"), (3001, True, 1e-2, "fast"),
    (3001, False, 1e-9, "masked"), (9001, True, 1e-9, "auto")])
def test_b6_square_vs_bf16_plain(cuda, n, masses, softening, mode):
    pos, m = _b6_case(n, 30, masses, cuda, softening == 1e-9)
    overlap = mf.square_overlap_only(pos, mode)
    assert not (overlap and softening == 1e-9)  # the scan finds the pair
    before = _count("launch.B6")
    f, s = mf.hybrid_forces(pos, pos, m, softening, overlap_only=overlap,
                            with_sums=True)
    assert _count("launch.B6") == before + 1
    want = mf.hybrid_sums_plain(pos, pos, m, softening, mf.KERNEL_TILE,
                                mf.KERNEL_TILE, overlap,
                                mma_dtype=torch.bfloat16)
    _close_cols(s, want)
    _close(f, mf.body_force_mxu(pos, pos, m, softening, coincident=mode),
           0.0, 0.0)


@pytest.mark.parametrize("masses", [False, True])
def test_b6_rect_vs_bf16_plain(cuda, masses):
    pos, m = _b6_case(3001, 31, masses, cuda, True)
    sub = pos[:64].contiguous()
    f, s = mf.hybrid_forces(sub, pos, m, 1e-9, with_sums=True)
    want = mf.hybrid_sums_plain(sub, pos, m, 1e-9, mf.KERNEL_TILE,
                                mf.KERNEL_TILE, mma_dtype=torch.bfloat16)
    _close_cols(s, want)
    _close(f, body_force_torch(sub.double(), pos.double(),
                               None if m is None else m.double()), 2e-2, 5e-3)


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("square", [False, True])
def test_b6_fp32_vs_fp64_oracle(cuda, masses, square):
    pos, m = _b6_case(3001, 32, masses, cuda, True)
    pi = pos if square else pos[:1000].contiguous()
    got = mf.body_force_mxu(pi, pos, m, 1e-9, pair_dtype="float32")
    want = body_force_torch(pi.double(), pos.double(),
                            None if m is None else m.double())
    _close(got, want, 1e-3, 1e-4)


@pytest.mark.parametrize("pair_dtype", ["bfloat16", "float32"])
def test_b6_auto_and_fast_bitwise_equal_masked(cuda, pair_dtype):
    # No atomics: on duplicate-free bodies the overlap run is the masked run
    # bit for bit, on the card as on the CPU.
    pos, m = _b6_case(9001, 33, True, cuda, False)
    assert not sm.any_coincident(pos)
    ref = mf.body_force_mxu(pos, pos, m, pair_dtype=pair_dtype)
    for mode in ("auto", "fast"):
        got = mf.body_force_mxu(pos, pos, m, pair_dtype=pair_dtype,
                                coincident=mode)
        assert torch.equal(got, ref), mode


@pytest.mark.parametrize("masses", [False, True])
def test_b6_bf16_vs_fp64_oracle(cuda, masses):
    pos, m = _b6_case(4096, 34, masses, cuda, False)
    got = mf.body_force_mxu(pos, pos, m, 1e-2)
    want = body_force_torch(pos.double(), pos.double(),
                            None if m is None else m.double(), softening=1e-2)
    _close(got, want, 2e-2, 5e-3)


def test_b6_long_rows_vs_fp64_oracle(cuda):
    # 131,072 sources per row: a tensor-core accumulator carried across all
    # 1024 j tiles drifts (its adds do not round to nearest) and the
    # epilogue's cancellation lifts that above the bf16 class; B6 adds a
    # fresh partial per tile in fp32.
    n = 131072
    pos = _pos(n, 37, cuda)
    rows = pos[:512].contiguous()
    got = mf.body_force_mxu(rows, pos)
    want = body_force_torch(rows.double(), pos.double(), row_chunk=64)
    _close(got, want, 2e-2, 5e-3)


#: Receiver and source counts around B6's 16-row strips and 128-body tiles.
B6_RAGGED = (1, 15, 17, 129, 3001)


@pytest.mark.parametrize("ni", B6_RAGGED)
@pytest.mark.parametrize("nj", B6_RAGGED)
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("softening", [1e-2, 0.0])
def test_b6_ragged_vs_bf16_plain(cuda, ni, nj, masses, softening):
    # Masked on separate receivers; on the square ones also the masked and
    # the overlap run with pos_i the sources. The forces are the sums'
    # epilogue bit for bit (both round each step).
    pj = _pos(nj, 70 + nj, cuda)
    m = torch.rand(nj, device=cuda) + 0.5 if masses else None
    runs = [(_pos(ni, 80 + ni, cuda), False)]
    if ni == nj:
        runs += [(pj, False), (pj, True)]
    for pi, overlap in runs:
        before = _count("launch.B6")
        f, s = mf.hybrid_forces(pi, pj, m, softening, overlap_only=overlap,
                                with_sums=True)
        assert _count("launch.B6") == before + 1
        want = mf.hybrid_sums_plain(pi, pj, m, softening, mf.KERNEL_TILE,
                                    mf.KERNEL_TILE, overlap,
                                    mma_dtype=torch.bfloat16)
        _close_cols(s, want)
        assert torch.equal(f, mf._epilogue(pi, s))


def _occupancy(fn, *args, threads=False):
    """(registers, local bytes, CTAs per SM) from a kernel's occupancy
    query; with threads, B10's, B12's or B14's threads per CTA as well."""
    import ctypes

    from mini_nbody_tpu_torch import _build

    lib = _build.load_library()
    out = (ctypes.c_int * 4)()
    _build.check(lib, getattr(lib, fn)(*args, ctypes.addressof(out)), fn)
    return tuple(out) if threads else tuple(out)[:3]


@pytest.mark.parametrize("masses", [0, 1])
def test_b6_registers_without_spills(cuda, masses):
    # The bf16 class's cap: 96 registers, so 5 CTAs of 4 warps per SM.
    regs, local, ctas = _occupancy("mxu_force_info", 1, masses)
    assert regs <= 96 and local == 0 and ctas >= 5


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("split_w", [0, 1])
@pytest.mark.parametrize("fast", [0, 1])
def test_b16_registers_without_spills(cuda, tile, split_w, fast):
    # 128 registers and 16 warps per SM; with split_w K2's cap, 168 and 12.
    regs, local, ctas = _occupancy("band_mxu_info", tile, split_w, fast)
    cap, warps = (168, 12) if split_w else (128, 16)
    assert regs <= cap and local == 0 and ctas * tile // 32 >= warps


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses", [0, 1])
def test_b14_registers_without_spills(cuda, tile, masses):
    # One strip per warp; 24 warps per SM with masses (at most 85
    # registers), 16 with unit masses (at most 128).
    regs, local, ctas = _occupancy("vjp_rect_mxu_info", tile, masses)
    cap, warps = (85, 24) if masses else (128, 16)
    assert regs <= cap and local == 0 and ctas * 2 * tile // 32 >= warps


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses", [0, 1])
def test_b14_threads_are_the_design(cuda, tile, masses):
    # tests/test_torch_vjp_design.py models B14 at vm.rect_threads(tile).
    *_, threads = _occupancy("vjp_rect_mxu_info", tile, masses, threads=True)
    assert threads == vm.rect_threads(tile)


@pytest.mark.parametrize("block", [32, 64, 96, 128, 256, 512, 1024])
@pytest.mark.parametrize("masses", [0, 1])
def test_b10_threads_are_the_design(cuda, block, masses):
    # tests/test_torch_vjp_design.py models B10 at
    # vk.ordered_receivers(block) receivers a thread.
    *_, threads = _occupancy("vjp_ordered_info", block, masses,
                             threads=True)
    assert threads == block // vk.ordered_receivers(block)


@pytest.mark.parametrize("block", [32, 64, 256, 512, 1024])
@pytest.mark.parametrize("masses", [0, 1])
def test_b10_registers_without_spills(cuda, block, masses):
    # At most 128 registers (4 receivers a thread), so 16 warps per SM.
    regs, local, ctas = _occupancy("vjp_ordered_info", block, masses)
    assert regs <= 128 and local == 0 and ctas >= 1


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_b4_vs_bf16_plain(cuda, tile, masses, mask):
    na, nb = 700, 1300
    pos, m = _b6_case(na + nb, 35, masses, cuda, False)
    ma, mb = (None, None) if m is None else (m[:na], m[na:])
    pa, va = sm._pack(pos[:na], ma, na, sm.round_up(na, tile))
    pb, vb = sm._pack(pos[na:], mb, nb, sm.round_up(nb, tile))
    acc_a = torch.zeros((pa.shape[0], 8), device=cuda)
    acc_b = torch.zeros((pb.shape[0], 8), device=cuda)
    slots = sp.slot_table(pa.shape[0] // tile, False, True, cuda,
                          nb_b=pb.shape[0] // tile)
    before = _counts("launch.K2", "launch.K2.cross", "launch.B4")
    sp.pair_slot_sums_(acc_a, acc_b, pa, pb, va, vb, slots, tile, 1e-9,
                       mask=mask)
    # B4 is counted apart from K2's own tri and cross calls
    assert _counts("launch.K2", "launch.K2.cross", "launch.B4") == (
        before[0], before[1], before[2] + 1)
    want = sp.cross_slot_sums_plain(pa, pb, va, vb, 1e-9, tile, mask=mask,
                                    mma_dtype=torch.bfloat16)
    _close_cols(acc_a[:na], want[0].T[:na])
    _close_cols(acc_b[:nb], want[1].T[:nb])


@pytest.mark.parametrize("masses", [False, True])
def test_b4_vs_b6_and_fp64_oracle(cuda, masses):
    na, nb = 900, 2100
    pos, m = _b6_case(na + nb, 36, masses, cuda, False)
    pa, pb = pos[:na].contiguous(), pos[na:].contiguous()
    ma, mb = (None, None) if m is None else (m[:na].contiguous(),
                                             m[na:].contiguous())
    before = _count("launch.B4")
    fa, fb = sm.body_force_pair_mxu(pa, pb, ma, mb, 1e-2, coincident="auto")
    assert _count("launch.B4") == before + 1
    for got, pi, pj, mj in ((fa, pa, pb, mb), (fb, pb, pa, ma)):
        want = body_force_torch(pi.double(), pj.double(),
                                None if mj is None else mj.double(),
                                softening=1e-2)
        _close(got, want, 2e-2, 5e-3)
        _close(got, mf.body_force_mxu(pi, pj, mj, 1e-2), 2e-2, 5e-3)
    with pytest.raises(ValueError, match="both masses"):
        sm.body_force_pair_mxu(pa, pb, None, torch.ones(nb, device=cuda))


@pytest.mark.parametrize("pair_dtype", ["bfloat16", "float32"])
def test_mxu_simulate_and_grad_go_through_b6(cuda, monkeypatch, pair_dtype):
    from mini_nbody_tpu_torch.ops import autodiff

    n = 3000
    gen = torch.Generator(device=cuda).manual_seed(5)
    state = init.plummer(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, steps=3, backend="mxu", pair_dtype=pair_dtype,
                    softening=1e-2, dt=1e-3, integrator="leapfrog",
                    use_masses=True)
    before = _count("launch.B6")
    out = simulate(cfg, state)
    torch.cuda.synchronize()
    assert _count("launch.B6") == before + 4  # the initial pass + one per step
    ref = simulate(cfg.replace(backend="torch"), state)
    _close(out.pos, ref.pos, 1e-3, 1e-4)
    # The backward by class, bf16 -> B13 and fp32 -> B11, on either side
    # of JAX's _SYM_BWD_MAX (lowered here).
    for bound in (4096, 2048):
        monkeypatch.setattr(autodiff, "_SYM_BWD_MAX", bound)
        names = ("launch.B10", "launch.B11", "launch.B13", "launch.B14",
                 "launch.B6")
        counts = _counts(*names)
        p = state.pos.clone().requires_grad_(True)
        force = make_differentiable_force(cfg)
        (force(p, state.mass) ** 2).sum().backward()
        launched = list(_launched(counts, *names))
        bf16 = pair_dtype == "bfloat16"
        assert launched == [0, int(not bf16), int(bf16), 0, 1]
        g = 2.0 * force(state.pos, state.mass).detach()
        want = vk.vjp_ordered_plain(state.pos, g, state.pos, g, state.mass,
                                    state.mass, 1e-2)
        _close(p.grad, want, *((2e-2, 5e-3) if bf16 else (1e-3, 1e-4)))


def _slot_runs(kernel, pos, g, m):
    """One whole call of a slot kernel's wrapper at three chunks (tri and
    cross launches)."""
    masses = m is not None
    if kernel == "K2":
        return sm.body_force_sym_mxu(pos, m, chunk=1024, coincident="fast")
    if kernel == "K3":
        return sf.body_force_symmetric(pos, m, chunk=1024)
    if kernel == "B11":
        return vk.vjp_pos_sym(pos, g, m, 1e-2, chunk=1024,
                              mass_grad=masses)
    return vm.vjp_pos_sym_mxu(pos, g, m, 1e-2, chunk=1024, mass_grad=masses)


@pytest.mark.parametrize("kernel", ["K2", "K3", "B11", "B13"])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("piece", [None, 100])
def test_slot_kernels_bitwise_run_to_run(cuda, monkeypatch, kernel, masses,
                                         piece):
    # piece = 100 cuts each slot list into many pieces.
    if piece is not None:
        monkeypatch.setattr(sp, "PIECE_SLOTS", piece)
    case = _vjp_case(3000, 40, masses, cuda)
    first = _slot_runs(kernel, *case)
    for _ in range(3):
        again = _slot_runs(kernel, *case)
        for a, b in zip(first if isinstance(first, tuple) else (first,),
                        again if isinstance(again, tuple) else (again,)):
            assert torch.equal(a, b)


def test_sym_mxu_auto_and_fast_bitwise_masked(cuda, monkeypatch):
    # K2's gate at 8192, so 'auto' runs the duplicate scan at 9192.
    monkeypatch.setattr(sm, "COINCIDENT_AUTO_MIN_N", 8192)
    pos = _pos(9192, 41, cuda)
    assert not sm.any_coincident(pos)
    ref = sm.body_force_sym_mxu(pos, chunk=4096, coincident="masked")
    for mode in ("auto", "fast"):
        got = sm.body_force_sym_mxu(pos, chunk=4096, coincident=mode)
        assert torch.equal(got, ref), mode


@pytest.mark.parametrize("backend", ["auto", "sym_mxu"])
def test_rollout_remat_bitwise(cuda, backend):
    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(6)
    s = init.plummer(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, dt=1e-3, softening=1e-2, integrator="leapfrog",
                    use_masses=True, backend=backend, sym_chunk=2048)
    carry0 = init_carry(cfg, s)
    grads = {}
    for remat in ("none", "step", "sqrt"):
        p = s.pos.clone().requires_grad_(True)
        st = BodyState(pos=p, vel=s.vel, mass=s.mass)
        out, _ = make_rollout_fn(cfg, 10, remat)((st, carry0[1]))
        (out.vel ** 2).sum().backward()
        grads[remat] = p.grad
    assert torch.equal(grads["sqrt"], grads["none"])
    assert torch.equal(grads["step"], grads["none"])


def _ensemble(n, b, masses, device, seed=42):
    gen = torch.Generator(device=device).manual_seed(seed)
    ss = [init.plummer(n, generator=gen, device=device) for _ in range(b)]
    return ss, BodyState(pos=torch.stack([s.pos for s in ss]),
                         vel=torch.stack([s.vel for s in ss]),
                         mass=torch.stack([s.mass for s in ss]))


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("n,tile", [(192, 64), (300, 64), (128, 128),
                                    (1000, None), (5000, None)])
def test_ensemble_force_bitwise_vs_standalone(cuda, mxu, masses, n, tile):
    # nb = 3, 5 (ragged), 1, and the default tile.
    ss, st = _ensemble(n, 3, masses, cuda)
    m = st.mass if masses else None
    t, c = sm.ensemble_tiling(n, tile, kernel=True)
    counts = _counts("launch.B9a", "launch.B9b")
    if mxu:
        f = sm.body_force_sym_mxu_ensemble(st.pos, m, tile=tile)
    else:
        f = sf.body_force_symmetric_ensemble(st.pos, m, tile=tile)
    assert _launched(counts, "launch.B9a", "launch.B9b") == (int(mxu),
                                                             int(not mxu))
    for i in range(3):
        mi = ss[i].mass if masses else None
        ref = (sm.body_force_sym_mxu(ss[i].pos, mi, tile=t, chunk=c) if mxu
               else sf.body_force_symmetric(ss[i].pos, mi, tile=t, chunk=c))
        assert torch.equal(f[i], ref), i


@pytest.mark.parametrize("mxu", [False, True])
def test_ensemble_grouping_keeps_the_bits(cuda, monkeypatch, mxu):
    # PIECE_SLOTS = 2 S: launches of 2, 2 and 1 systems against the
    # one-system standalone calls.
    n, tile = 1000, 128
    ss, st = _ensemble(n, 5, True, cuda, seed=43)
    t, c = sm.ensemble_tiling(n, tile, kernel=True)
    monkeypatch.setattr(sp, "PIECE_SLOTS", 2 * sp.n_slots_tri(c // t))
    run = (sm.body_force_sym_mxu_ensemble if mxu
           else sf.body_force_symmetric_ensemble)
    f = run(st.pos, st.mass, tile=tile)
    for i in range(5):
        one = run(st.pos[i:i + 1], st.mass[i:i + 1], tile=tile)
        assert torch.equal(f[i], one[0]), i


@pytest.mark.parametrize("backend", ["auto", "sym_mxu"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_simulate_ensemble_bitwise_vs_simulate(cuda, backend, integrator):
    from mini_nbody_tpu_torch import simulate_ensemble, trajectory_ensemble

    n = 700
    ss, st = _ensemble(n, 3, True, cuda, seed=44)
    cfg = SimConfig(n=n, dt=1e-3, steps=4, softening=1e-2, backend=backend,
                    integrator=integrator, use_masses=True,
                    resident=False)  # the streamed loop, not B15
    before = _counts("launch.B9a", "launch.B9b")
    out = simulate_ensemble(cfg, st)
    passes = {"euler": 4, "leapfrog": 5, "yoshida4": 13}[integrator]
    mxu = backend == "sym_mxu"
    assert _launched(before, "launch.B9a", "launch.B9b") == (
        passes * mxu, passes * (not mxu))
    t, c = sm.ensemble_tiling(n, None, kernel=True)
    for i in range(3):
        ref = simulate(cfg.replace(sym_tile=t, sym_chunk=c), ss[i])
        assert torch.equal(out.pos[i], ref.pos)
        assert torch.equal(out.vel[i], ref.vel)
    final, hist = trajectory_ensemble(cfg, st, save_every=2)
    assert hist.shape == (2, 3, n, 3)
    assert torch.equal(hist[-1], out.pos) and torch.equal(final.pos, out.pos)


def test_trajectory_last_snapshot_is_simulate(cuda):
    from mini_nbody_tpu_torch import trajectory

    n = 3000
    gen = torch.Generator(device=cuda).manual_seed(45)
    s = init.plummer(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, dt=1e-3, softening=1e-2, integrator="leapfrog",
                    use_masses=True, sym_chunk=1024)
    final, hist = trajectory(cfg, s, 6, save_every=3)
    ref = simulate(cfg, s, 6)
    assert hist.shape == (2, n, 3)
    assert torch.equal(hist[-1], ref.pos) and torch.equal(final.vel, ref.vel)


def test_b14_long_rows_vs_bf16_plain(cuda):
    # 131,072 sources per row: B14 adds a fresh tensor-core partial per j
    # tile in fp32, as B6 does; one fragment carried across all 1024 tiles
    # drifts (its adds do not round to nearest).
    n = 131072
    pos, g, _ = _vjp_case(n, 46, False, cuda)
    pk_, gk_ = pos[:512].contiguous(), g[:512].contiguous()
    got = vm.vjp_rect_mxu_rows(pk_, gk_, pos, g)
    want = vm.vjp_rect_mxu_plain(pk_, gk_, pos, g, mma_dtype=torch.bfloat16)
    _close_cols(got, want)
    ones = pos.new_ones(512)
    _close(vm._combine(got, ones, gk_, pk_), vm._combine(want, ones, gk_, pk_),
           2e-2, 5e-3)
    _close(vm.vjp_rect_mxu(pk_, gk_, pos, g),
           vk.vjp_ordered_plain(pk_, gk_, pos, g), 2e-2, 5e-3)


@pytest.mark.parametrize("mxu", [False, True])
def test_ensemble_past_the_grid_limit(cuda, mxu):
    # 65,600 one-slot systems (N = 64, tile 64): two launches, of 65,535
    # systems (gridDim.y's limit) and 65, each system bitwise standalone.
    b, n = 65600, 64
    pos = _pos(b * n, 47, cuda).view(b, n, 3)
    m = torch.rand((b, n), device=cuda) + 0.5
    counts = _counts("launch.B9a", "launch.B9b", "launch.slot_reduce")
    if mxu:
        f = sm.body_force_sym_mxu_ensemble(pos, m)
    else:
        f = sf.body_force_symmetric_ensemble(pos, m)
    assert _launched(counts, "launch.B9a", "launch.B9b",
                     "launch.slot_reduce") == (2 * mxu, 2 * (not mxu), 2)
    for i in (0, 65534, 65535, b - 1):
        ref = (sm.body_force_sym_mxu(pos[i], m[i], tile=64, chunk=64) if mxu
               else sf.body_force_symmetric(pos[i], m[i], tile=64, chunk=64))
        assert torch.equal(f[i], ref), i


@pytest.mark.parametrize("cross", [False, True])
def test_slot_reduce_bitwise_plain(cuda, cross):
    # The kernel adds each block's partials in slot order, as the plain
    # version does: the same bits, for two systems of a piece.
    tile, width, nb, n_sys = 64, 8, 12, 2
    slots = sp.slot_table(nb, True, cross, cuda)
    piece_plan = sp.reduce_plan(slots, not cross)[0]
    part = torch.randn(n_sys * slots.shape[0] * 2 * tile * width,
                       device=cuda)
    accs = []
    for run in (sp.slot_reduce_, sp.slot_reduce_plain):
        a, b = (torch.ones((n_sys * nb * tile, width), device=cuda)
                for _ in range(2))
        run(part, piece_plan, a, b if cross else a, tile, width, n_sys,
            nb * tile)
        accs.append((a, b))
    assert torch.equal(accs[0][0], accs[1][0])
    assert torch.equal(accs[0][1], accs[1][1])


def _lists_plan(lengths, n_tiles, device, seed):
    """A reduce plan of one piece: target t (t even: acc_a block t // 2,
    odd: acc_b) adds lengths[t] tiles drawn without replacement from the
    piece's n_tiles, in a shuffled list order."""
    rng = np.random.default_rng(seed)
    pick = rng.permutation(n_tiles)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    assert offsets[-1] <= n_tiles
    arrays = (np.arange(len(lengths)), offsets, pick[:offsets[-1]],
              sp.launch_order(offsets))
    return (0, n_tiles // 2, *(torch.from_numpy(a.astype(np.int32)).to(
        device) for a in arrays))


@pytest.mark.parametrize("width", [3, 4, 8])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("lengths", [(1, 7, 64, 1024), (2048, 1, 33),
                                     (5, 3, 9, 17, 31, 2049)])
@pytest.mark.parametrize("n_sys", [1, 3])
def test_slot_reduce_lists_bitwise_plain(cuda, width, tile, lengths, n_sys):
    # Lists of 1, 7, 64, 1024 and 2048 tiles (B12's row lists at 262,144
    # bodies and tile 128), lengths that are no multiple of the ring's depth
    # (4 .. 32) and one past a 2048-entry window of staged entries, targets
    # on both accumulators, over n_sys systems: bitwise the plain version.
    n_tiles = 2 * -(-sum(lengths) // 2)
    plan = _lists_plan(lengths, n_tiles, cuda, width + tile + n_sys)
    rows = tile * -(-len(lengths) // 2)
    part = torch.randn(n_sys * n_tiles * tile * width, device=cuda)
    accs = []
    for run in (sp.slot_reduce_, sp.slot_reduce_plain):
        torch.manual_seed(0)
        a, b = (torch.randn((n_sys * rows, width), device=cuda)
                for _ in range(2))
        run(part, plan, a, b, tile, width, n_sys, rows)
        accs.append((a, b))
    assert torch.equal(accs[0][0], accs[1][0])
    assert torch.equal(accs[0][1], accs[1][1])


@pytest.mark.parametrize("what", ["part", "acc", "tile"])
def test_slot_reduce_refuses_misaligned(cuda, what):
    # float4 copies need 16-byte aligned partials and accumulators and a
    # tile of a multiple of 4 floats: such a call is refused, never run on
    # a slower path.
    tile, width = 64, 3
    plan = _lists_plan((3, 5), 8, cuda, 0)
    part = torch.randn(8 * tile * width + 1, device=cuda)
    acc = torch.zeros((tile * width + 1,), device=cuda)
    args = {"part": (part[1:], acc[:-1].view(tile, width), tile),
            "acc": (part[:-1], acc[1:].view(tile, width), tile),
            "tile": (part[:-1], acc[:-1].view(tile, width), tile - 1)}[what]
    p, a, t = args
    with pytest.raises(RuntimeError, match="slot_reduce_launch"):
        sp.slot_reduce_(p, plan, a, a, t, width)


# ------------------------------------------------- B9c, B9d: ensemble VJPs

def _ens_vjp(mxu):
    if mxu:
        return (vm.vjp_pos_sym_mxu_ensemble, vm.vjp_pos_sym_mxu,
                "launch.B9d")
    return (vk.vjp_pos_sym_ensemble, vk.vjp_pos_sym,
            "launch.B9c")


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("mass_grad", [False, True])
@pytest.mark.parametrize("n,tile", [(192, 64), (300, 64), (128, 128)])
def test_ensemble_vjp_bitwise_vs_standalone(cuda, mxu, mass_grad, n, tile):
    # nb = 3 (odd), 5 (odd, ragged), 1: one launch holds the 3 systems.
    ss, st = _ensemble(n, 3, True, cuda, seed=48)
    g = torch.sin(7.0 * st.pos)
    ens, one, counter = _ens_vjp(mxu)
    before = _count(counter)
    got = ens(st.pos, g, st.mass, tile=tile, mass_grad=mass_grad)
    assert _count(counter) == before + 1
    got = got if mass_grad else (got,)
    for i in range(3):
        ref = one(st.pos[i], g[i], st.mass[i], tile=tile,
                  mass_grad=mass_grad)
        ref = ref if mass_grad else (ref,)
        for a, b in zip(got, ref):
            assert torch.equal(a[i], b), i


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_ensemble_vjp_sums_vs_plain(cuda, mxu, masses):
    b, n, tile = 3, 1000, 64
    _, st = _ensemble(n, b, True, cuda, seed=49)
    g = torch.sin(7.0 * st.pos)
    m = st.mass if masses else None
    c = 1024
    slots = sp.slot_table(c // tile, True, False, cuda)
    if mxu:
        (_, _), (p, gp, q) = vm.ensemble_sums_inputs(st.pos, g, m, tile)
        ko = 9 if masses else 8
        got, want = (torch.zeros((b * c, ko), device=cuda) for _ in range(2))
        vm.vjp_mxu_sums_ensemble_(got, p, gp, q, slots, tile, 1e-2, b)
        vm.vjp_mxu_sums_plain(want, want, p, p, gp, gp, q, q, slots, tile,
                              1e-2, True, mma_dtype=torch.bfloat16, n_sys=b)
        _close_cols(got, want)
    else:
        p = sm.pack_ensemble(st.pos, m, c, sf._pack)
        gp = vk.pad_systems(g, c)
        ko = 4 if masses else 3
        got, want = (torch.zeros((b * c, ko), device=cuda) for _ in range(2))
        vk.vjp_sym_sums_ensemble_(got, p, gp, slots, tile, 1e-2, b)
        vk.vjp_sym_sums_plain(want, want, p, p, gp, gp, slots, tile, 1e-2,
                              True, n_sys=b)
        _close(got, want, 1e-3, 1e-4)


@pytest.mark.parametrize("backend", ["sym", "sym_mxu"])
def test_ensemble_grad_per_system_and_no_leakage(cuda, backend):
    n, tile = 300, 64
    ss, st = _ensemble(n, 3, True, cuda, seed=50)
    cfg = SimConfig(n=n, backend=backend, use_masses=True, softening=1e-2,
                    sym_tile=tile, sym_bwd_tile=tile)
    force = make_differentiable_ensemble_force(cfg)
    p = st.pos.clone().requires_grad_(True)
    torch.sin(force(p, st.mass)).sum().backward()
    one = make_differentiable_force(cfg)
    for i in range(3):
        q = ss[i].pos.clone().requires_grad_(True)
        torch.sin(one(q, ss[i].mass)).sum().backward()
        assert torch.equal(p.grad[i], q.grad), i
    p = st.pos.clone().requires_grad_(True)
    (force(p, st.mass)[0] ** 2).sum().backward()
    assert p.grad[0].abs().max() > 0
    assert torch.equal(p.grad[1:], torch.zeros_like(p.grad[1:]))


# ------------------------------------------ B15: the resident trajectory

#: B15 against its plain version, by class (mxu), at 1000 plummer bodies
#: and 5 steps: chip_smoke.py's RES_PLAIN_TOL["plummer"]. Measured on an
#: H100 over test_b15_vs_plain's cases: at most 1.15e-5 in both classes.
RES_PLAIN = {False: 1e-4, True: 1e-4}


def _close_change(got, want, start, tol):
    """got's change from start within tol of the scale of want's change
    (max |want - start|): a run that dropped the forces is off by all of
    it."""
    start = start.double().cpu()
    dg_, dw = got.double().cpu() - start, want.double().cpu() - start
    assert torch.isfinite(dg_).all()
    assert ((dg_ - dw).abs() <= tol * dw.abs().max()).all()


def _padded(s, n, tile, masses):
    """pos, vel (1, Np, 3) and mass (1, Np) or None, FAR-padded as B15
    pads them."""
    pad = -(-n // tile) * tile - n
    pos = torch.cat([s.pos, s.pos.new_full((pad, 3), 1.0e18)])[None]
    vel = torch.cat([s.vel, s.vel.new_zeros((pad, 3))])[None]
    m = torch.cat([s.mass, s.mass.new_zeros(pad)])[None] if masses else None
    return pos.contiguous(), vel.contiguous(), m


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("tile", [64, 128])
def test_b15_vs_plain(cuda, mxu, masses, fold, tile):
    n, steps = 1000, 5
    ss, _ = _ensemble(n, 1, True, cuda, seed=51)
    s = ss[0]
    before = _count("launch.B15")
    pos, vel = rs.simulate_resident_sym(
        s.pos, s.vel, s.mass if masses else None, steps=steps, dt=1e-3,
        softening=1e-2, mxu=mxu, tile=tile, fold=fold)
    assert _count("launch.B15") == before + 1
    p, v, m = _padded(s, n, tile, masses)
    slots = sp.slot_table(p.shape[1] // tile, fold, False, cuda)
    rs.resident_plain(p, v, m, slots, tile, n, steps, 1e-3, 1e-2, mxu, True,
                      mma_dtype=torch.bfloat16 if mxu else torch.float32)
    _close_change(pos, p[0, :n], s.pos, RES_PLAIN[mxu])
    _close_change(vel, v[0, :n], s.vel, RES_PLAIN[mxu])


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("masses", [False, True])
def test_b15_ensemble_bitwise_vs_standalone(cuda, mxu, masses):
    n, b = 300, 3
    ss, st = _ensemble(n, b, masses, cuda, seed=52)
    m = st.mass if masses else None
    kw = dict(steps=4, dt=1e-3, softening=1e-2, mxu=mxu, tile=64)
    before = _count("launch.B15")
    p, v = rs.simulate_resident_sym_ensemble(st.pos, st.vel, m, **kw)
    assert _count("launch.B15") == before + 1
    for i in range(b):
        pi, vi = rs.simulate_resident_sym(ss[i].pos, ss[i].vel,
                                          ss[i].mass if masses else None,
                                          **kw)
        assert torch.equal(p[i], pi) and torch.equal(v[i], vi), i


@pytest.mark.parametrize("mxu", [False, True])
def test_b15_reruns_and_y4_phase_split_bitwise(cuda, mxu):
    ss, _ = _ensemble(200, 1, True, cuda, seed=53)
    s = ss[0]
    cycle, _ = rs.y4_cycle(1e-3)
    kw = dict(dt=1e-3, softening=1e-2, mxu=mxu, tile=64, y4=cycle)
    one = rs.simulate_resident_sym(s.pos, s.vel, s.mass, steps=8, **kw)
    again = rs.simulate_resident_sym(s.pos, s.vel, s.mass, steps=8, **kw)
    assert torch.equal(one[0], again[0]) and torch.equal(one[1], again[1])
    p, v = s.pos, s.vel
    for start, k in ((0, 3), (3, 4), (7, 1)):
        p, v = rs.simulate_resident_sym(p, v, s.mass, steps=k,
                                        y4_phase=start, **kw)
    assert torch.equal(p, one[0]) and torch.equal(v, one[1])


@pytest.mark.parametrize("mxu", [False, True])
def test_b15_auto_is_masked_and_fast_fold_over_pads_is_finite(cuda, mxu):
    # N = 200 at tile 64: 56 pads in block 3, which folds with block 2.
    n = 200
    ss, _ = _ensemble(n, 1, False, cuda, seed=54)
    s = ss[0]
    kw = dict(steps=20, dt=1e-3, softening=1e-9, mxu=mxu, tile=64, fold=True)
    out = {mode: rs.simulate_resident_sym(s.pos, s.vel, None,
                                          coincident=mode, **kw)
           for mode in ("auto", "masked", "fast")}
    assert torch.equal(out["auto"][0], out["masked"][0])
    assert torch.equal(out["auto"][1], out["masked"][1])
    rtol, atol = (2e-2, 2e-3) if mxu else (1e-4, 1e-5)
    for k in (0, 1):
        _close(out["fast"][k], out["masked"][k], rtol, atol)


@pytest.mark.parametrize("backend", ["auto", "sym_mxu"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_simulate_resident_route(cuda, backend, integrator):
    n = 1000
    ss, st = _ensemble(n, 3, True, cuda, seed=55)
    cfg = SimConfig(n=n, dt=1e-3, steps=4, softening=1e-2, backend=backend,
                    integrator=integrator, use_masses=True)
    before = _count("launch.B15")
    res = simulate(cfg.replace(resident=True), ss[0])
    assert _count("launch.B15") == before + 1
    ref = simulate(cfg.replace(resident=False), ss[0])
    assert torch.equal(res.pos, ref.pos) and torch.equal(res.vel, ref.vel)
    t, c = sm.ensemble_tiling(n, None, kernel=True)
    rcfg = cfg.replace(resident=True, sym_tile=t, sym_chunk=c)
    before = _count("launch.B15")
    out = simulate_ensemble(rcfg, st)
    assert _count("launch.B15") == before + 1
    for i in range(3):
        one = simulate(rcfg, ss[i])
        assert torch.equal(out.pos[i], one.pos)
        assert torch.equal(out.vel[i], one.vel)


@pytest.mark.parametrize("backend", ["auto", "sym_mxu"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_default_route_changes_no_bit(cuda, backend, integrator):
    # resident=None: simulate routes N = 3000 to B15 at the streamed tile
    # (128; B15's own default would take 64); trajectory, which streams,
    # ends on simulate's bits. An ensemble above the ensemble crossover
    # streams while each system alone routes to B15: each system is bitwise
    # its simulate all the same.
    from mini_nbody_tpu_torch import sim as tsim
    from mini_nbody_tpu_torch import trajectory

    eff = "sym" if backend == "auto" else backend
    steps = max(4, tsim.RESIDENT_AUTO_MIN_STEPS[integrator])
    n = 3000
    assert n <= tsim.RESIDENT_AUTO_MAX_N[eff] and rs.auto_tile(n) == 64
    cfg = SimConfig(n=n, dt=1e-3, steps=steps, softening=1e-2,
                    backend=backend, integrator=integrator, use_masses=True)
    s = _ensemble(n, 1, True, cuda, seed=60)[0][0]
    before = _count("launch.B15")
    out = simulate(cfg, s)
    assert _count("launch.B15") == before + 1
    ref = simulate(cfg.replace(resident=False), s)
    assert torch.equal(out.pos, ref.pos) and torch.equal(out.vel, ref.vel)
    final, hist = trajectory(cfg, s, steps)
    assert torch.equal(final.pos, out.pos) and torch.equal(final.vel, out.vel)
    assert torch.equal(hist[-1], out.pos)
    n = 2 * tsim.RESIDENT_ENSEMBLE_AUTO_MAX_N[eff]
    assert n <= tsim.RESIDENT_AUTO_MAX_N[eff]
    ss, st = _ensemble(n, 3, True, cuda, seed=61)
    cfg = cfg.replace(n=n)
    before = _count("launch.B15")
    ens = simulate_ensemble(cfg, st)
    assert _count("launch.B15") == before
    t, c = sm.ensemble_tiling(n, None, kernel=True)
    for i in range(3):
        one = simulate(cfg.replace(sym_tile=t, sym_chunk=c), ss[i])
        assert torch.equal(ens.pos[i], one.pos), i
        assert torch.equal(ens.vel[i], one.vel), i
    assert _count("launch.B15") == before + 3


@pytest.mark.parametrize("backend", ["auto", "sym_mxu"])
def test_auto_routes_small_n_to_b15(cuda, backend):
    # resident=None: B15 at or below the card's crossover (sim.py), the
    # streamed loop above it; an ensemble likewise by its per-system N.
    from mini_nbody_tpu_torch import sim as tsim

    eff = "sym" if backend == "auto" else backend
    steps = tsim.RESIDENT_AUTO_MIN_STEPS["euler"]
    for n, routed in ((tsim.RESIDENT_AUTO_MAX_N[eff], True),
                      (2 * tsim.RESIDENT_AUTO_MAX_N[eff], False)):
        s = init.uniform_random(n, generator=torch.Generator(
            device=cuda).manual_seed(56), device=cuda)
        before = _count("launch.B15")
        simulate(SimConfig(n=n, steps=steps, backend=backend), s)
        assert _count("launch.B15") - before == int(routed), n
    n = tsim.RESIDENT_ENSEMBLE_AUTO_MAX_N[eff]
    _, st = _ensemble(n, 4, True, cuda, seed=57)
    before = _count("launch.B15")
    simulate_ensemble(SimConfig(n=n, steps=steps, backend=backend), st)
    assert _count("launch.B15") - before == 1


@pytest.mark.parametrize("mxu", [False, True])
def test_ensemble_vjp_grouping_keeps_the_bits(cuda, monkeypatch, mxu):
    # PIECE_SLOTS = 2 S: B9c / B9d launches of 2, 2 and 1 systems against
    # one-system calls, the mass cotangent included.
    n = 1000
    _, st = _ensemble(n, 5, True, cuda, seed=58)
    g = torch.sin(7.0 * st.pos)
    ens, _, _ = _ens_vjp(mxu)
    tile = vm.DEFAULT_TILE if mxu else vk.DEFAULT_TILE
    t, c = sm.ensemble_tiling(n, tile, kernel=True)
    monkeypatch.setattr(sp, "PIECE_SLOTS", 2 * sp.n_slots_tri(c // t))
    got = ens(st.pos, g, st.mass, mass_grad=True)
    for i in range(5):
        k = slice(i, i + 1)
        one = ens(st.pos[k], g[k], st.mass[k], mass_grad=True)
        assert torch.equal(got[0][i], one[0][0]), i
        assert torch.equal(got[1][i], one[1][0]), i


@pytest.mark.parametrize("mxu", [False, True])
def test_b15_many_pieces(cuda, monkeypatch, mxu):
    # Pieces of 7 slots: B15's per-piece barriers and reduces, and the
    # last piece's sums added by the integrating thread (some blocks are
    # no target of the last piece). Each system bitwise its standalone
    # run, the Euler, leapfrog and Yoshida-4 runs bitwise the streamed
    # runs (the same slot bodies, pieces and adds), and the plain schedule
    # within the class bound.
    monkeypatch.setattr(sp, "PIECE_SLOTS", 7)
    n, tile = 1000, 64
    ss, st = _ensemble(n, 3, True, cuda, seed=59)
    kw = dict(steps=3, dt=1e-3, softening=1e-2, mxu=mxu, tile=tile)
    p, v = rs.simulate_resident_sym_ensemble(st.pos, st.vel, st.mass, **kw)
    for i in range(3):
        pi, vi = rs.simulate_resident_sym(ss[i].pos, ss[i].vel, ss[i].mass,
                                          **kw)
        assert torch.equal(p[i], pi) and torch.equal(v[i], vi), i
    cfg = SimConfig(n=n, steps=3, dt=1e-3, softening=1e-2, use_masses=True,
                    sym_tile=tile, backend="sym_mxu" if mxu else "sym",
                    resident=False)
    ref = simulate(cfg, ss[0])
    assert torch.equal(p[0], ref.pos) and torch.equal(v[0], ref.vel)
    for integrator in ("leapfrog", "yoshida4"):
        kdk = cfg.replace(integrator=integrator)
        before = _count("launch.B15")
        res = simulate(kdk.replace(resident=True), ss[0])
        assert _count("launch.B15") == before + 1
        ref = simulate(kdk, ss[0])
        assert torch.equal(res.pos, ref.pos), integrator
        assert torch.equal(res.vel, ref.vel), integrator
    pp, vv, mm = _padded(ss[0], n, tile, True)
    slots = sp.slot_table(pp.shape[1] // tile, True, False, cuda)
    last = rs.resident_plan(slots)[3]
    assert len(rs.resident_plan(slots)[0]) > 1 and (last < 0).any()
    rs.resident_plain(pp, vv, mm, slots, tile, n, 3, 1e-3, 1e-2, mxu, True,
                      mma_dtype=torch.bfloat16 if mxu else torch.float32)
    _close_change(p[0], pp[0, :n], ss[0].pos, RES_PLAIN[mxu])
    _close_change(v[0], vv[0, :n], ss[0].vel, RES_PLAIN[mxu])


def _streamed_launches():
    """The launch counts of the streamed force kernels and the reduce: K2,
    K3, B9a, B9b and slot_reduce."""
    return _counts("launch.K2", "launch.K3", "launch.B9a", "launch.B9b",
                   "launch.slot_reduce")


@pytest.mark.parametrize("backend", ["auto", "sym_mxu"])
@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4"])
def test_routed_kdk_is_one_b15_launch(cuda, backend, integrator):
    # resident=None: a leapfrog or Yoshida-4 simulate and simulate_ensemble
    # call within the crossovers is one B15 launch, its opening and
    # closing passes included, with no streamed force launch and no
    # slot_reduce; each bitwise the streamed loop.
    from mini_nbody_tpu_torch import sim as tsim

    eff = "sym" if backend == "auto" else backend
    steps = max(3, tsim.RESIDENT_AUTO_MIN_STEPS[integrator])
    n = min(1000, tsim.RESIDENT_ENSEMBLE_AUTO_MAX_N[eff])
    ss, st = _ensemble(n, 3, True, cuda, seed=62)
    cfg = SimConfig(n=n, dt=1e-3, steps=steps, softening=1e-2,
                    backend=backend, integrator=integrator, use_masses=True)
    for run, state in ((simulate, ss[0]), (simulate_ensemble, st)):
        before, streamed = _count("launch.B15"), _streamed_launches()
        out = run(cfg, state)
        assert _count("launch.B15") == before + 1, run.__name__
        assert _streamed_launches() == streamed, run.__name__
        ref = run(cfg.replace(resident=False), state)
        assert torch.equal(out.pos, ref.pos), run.__name__
        assert torch.equal(out.vel, ref.vel), run.__name__


def test_resident_sweep_is_one_launch(cuda):
    # examples/parameter_sweep.py at its defaults (32 systems of 1024
    # plummer bodies, 200 leapfrog steps on sym_mxu) on the resident
    # ensemble: one B15 launch, no B9a, bitwise the streamed ensemble.
    b, n = 32, 1024
    gen = torch.Generator(device=cuda).manual_seed(63)
    base = init.plummer(n, generator=gen, device=cuda)
    q = torch.linspace(0.2, 1.6, b, device=cuda)
    st = BodyState(pos=base.pos.expand(b, n, 3).contiguous(),
                   vel=(base.vel[None] * q[:, None, None]).contiguous(),
                   mass=base.mass.expand(b, n).contiguous())
    cfg = SimConfig(n=n, dt=2e-3, steps=200, softening=1e-3,
                    integrator="leapfrog", use_masses=True,
                    backend="sym_mxu", resident=True)
    before, streamed = _count("launch.B15"), _streamed_launches()
    out = simulate_ensemble(cfg, st)
    assert _count("launch.B15") == before + 1
    assert _streamed_launches() == streamed
    ref = simulate_ensemble(cfg.replace(resident=False), st)
    assert torch.equal(out.pos, ref.pos) and torch.equal(out.vel, ref.vel)


@pytest.mark.parametrize("tile", [64, 128])
def test_b15_occupancy(cuda, tile):
    # The force phase's warps per SM (csrc/resident_sym.cu res_min_ctas):
    # the fp32 class at least 2 CTAs per SM with no spills, K3's 16 warps
    # at tile 128 and 12 at tile 64; both bf16 instantiations no fewer CTAs
    # per SM than K2 (slot_pipe_info), the wide one 16 warps.
    for k in (3, 4):
        for fast in (0, 1):
            regs, local, ctas = _occupancy("resident_sym_info", tile, 0, k,
                                           fast, 0)
            assert ctas >= 2 and local == 0, (k, fast)
            warps = ctas * (tile // 8) ** 2 // 32
            assert warps >= (16 if tile == 128 else 12), (k, fast)
    _, _, k2 = _occupancy("slot_pipe_info", tile, 0)
    for wide in (0, 1):
        regs, local, ctas = _occupancy("resident_sym_info", tile, 1, 3, 1,
                                       wide)
        assert ctas >= k2, wide
        assert not wide or ctas * tile // 32 >= 16


# ------------------------------------------------ band traversal (B16)

def _band_sums(mode, p, v, c, tile, split_w, mask, n_sys=1, plain=False):
    """One B16 call, or its plain version in bf16 mode, on packed bodies:
    'tri' on rows [0, c), 'ensemble' on n_sys systems of c rows, 'cross' on
    the chunk pair ([0, c), [c, 2c)): the rows then the cols, stacked."""
    rows = torch.zeros((c * (2 if mode == "cross" else n_sys), 8),
                       device=p.device)
    cols = torch.zeros_like(rows)
    if mode == "cross":
        a, b = slice(0, c), slice(c, 2 * c)
        args = (rows[a], cols[b], p[a], p[b], v[a], v[b], tile, 1e-9,
                split_w, mask)
        if plain:
            sm._band_sums_plain(*args, True, torch.bfloat16)
        else:
            sm.band_cross_sums_(*args)
        return torch.cat([rows[a], cols[b]])
    if not plain and mode == "tri":
        sm.band_tri_sums_(rows, cols, p[:c], v[:c], tile, 1e-9, split_w, mask)
    elif not plain:
        sm.band_tri_sums_ensemble_(rows, cols, p[:n_sys * c], v[:n_sys * c],
                                   tile, 1e-9, n_sys, split_w, mask)
    else:
        for s in range(n_sys):
            q = slice(s * c, (s + 1) * c)
            sm._band_sums_plain(rows[q], cols[q], p[q], p[q], v[q], v[q],
                                tile, 1e-9, split_w, mask, False,
                                torch.bfloat16)
    return torch.cat([rows, cols])


def _close_band(got, want, real):
    # chip_smoke.py's band bound: the bf16 class per column.
    got, want = got[real].double().cpu(), want[real].double().cpu()
    assert torch.isfinite(got).all()
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    assert ((got - want).abs() <= 2e-2 * want.abs() + 5e-3 * scale).all()


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("mode,blocks", [("tri", 1), ("tri", 5), ("tri", 6),
                                         ("cross", 4), ("ensemble", 5)])
@pytest.mark.parametrize("mask,split_w", [(True, False), (False, False),
                                          (True, True)])
def test_b16_vs_bf16_plain(cuda, tile, mode, blocks, mask, split_w):
    # One block, odd with a ragged tail, even (the half-active wrap band);
    # a chunk pair with a ragged second chunk; 3 ragged systems; masses
    # unless the case is the masked unsplit one. Each call launches once and
    # stores its column partials for one reduce (none for one block).
    c, pads = blocks * tile, 0 if blocks in (1, 6) else 37
    n_sys = 3 if mode == "ensemble" else 1
    chunks = 2 if mode == "cross" else n_sys
    real = [c - (pads if mode == "ensemble" or s == chunks - 1 else 0)
            for s in range(chunks)]
    masses = (mask, split_w) != (True, False)
    packs = [sm._pack(_pos(r, 10 * blocks + s, cuda),
                      torch.rand(r, device=cuda) + 0.5 if masses else None,
                      r, c) for s, r in enumerate(real)]
    p, v = (torch.cat([x[k] for x in packs]) for k in (0, 1))
    counters = ("launch.B16.tri", "launch.B16.cross", "launch.B16.ensemble",
                "launch.band_reduce")
    before = [_count(k) for k in counters]
    args = (mode, p, v, c, tile, split_w, mask, n_sys)
    got = _band_sums(*args)
    launched = [_count(k) - b for k, b in zip(counters, before)]
    kind = ("tri", "cross", "ensemble").index(mode)
    assert launched[kind] == 1 and sum(launched[:3]) == 1
    assert launched[3] == int(mode != "tri" or blocks > 1)
    assert torch.equal(got, _band_sums(*args))
    keep = torch.cat([torch.arange(c, device=cuda) < r for r in
                      (real if mode == "cross" else real * 2)])
    _close_band(got, _band_sums(*args, plain=True), keep)


def test_b16_auto_fast_bitwise_masked_and_ensemble_standalone(cuda,
                                                             monkeypatch):
    monkeypatch.setattr(sm, "BAND_COINCIDENT_AUTO_MIN_N", 0)
    pos = _pos(5000, 61, cuda)
    ref = sm.body_force_sym_mxu(pos, chunk=2048, coincident="masked",
                                traversal="band")
    for mode in ("auto", "fast"):
        assert torch.equal(sm.body_force_sym_mxu(
            pos, chunk=2048, coincident=mode, traversal="band"), ref)
    assert torch.equal(sm.body_force_sym_mxu(
        pos, chunk=2048, traversal="band"), ref)
    b, n = 3, 1000
    pos = torch.stack([_pos(n, 62 + i, cuda) for i in range(b)])
    mass = torch.rand(b, n, device=cuda) + 0.5
    f = sm.body_force_sym_mxu_ensemble(pos, mass, traversal="band")
    t, c = sm.ensemble_tiling(n, None, kernel=True)
    for i in range(b):
        assert torch.equal(f[i], sm.body_force_sym_mxu(
            pos[i], mass[i], tile=t, chunk=c, traversal="band")), i
    _close(f, sm.body_force_sym_mxu_ensemble(pos, mass), 2e-2, 5e-3)


def test_simulate_band_goes_through_b16(cuda):
    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = init.uniform_random(n, generator=gen, device=cuda)
    cfg = SimConfig(n=n, steps=3, backend="sym_mxu", traversal="band",
                    softening=1e-2, integrator="leapfrog", sym_chunk=1024,
                    resident=False)
    before = _counts("launch.B16.tri", "launch.B16.cross", "launch.K2")
    out = simulate(cfg, state)
    torch.cuda.synchronize()
    launched = _launched(before, "launch.B16.tri", "launch.B16.cross",
                         "launch.K2")
    # 4 force passes of 4 tri and 6 cross calls, one launch each; no K2.
    assert launched == (16, 24, 0)
    ref = simulate(cfg.replace(traversal="slots"), state)
    _close(out.pos, ref.pos, 1e-2, 1e-3)


# ------------------- B11 and B13 on persistent register bodies (B9c, B9d)

#: Every instantiation of the pair-once VJPs: (masses, mass_grad), each in
#: the fp32 class (B11: ko 3, 3, 4) and the bf16 class (B13: ko 8, 8, 9).
PAIR_ONCE_KINDS = [(False, False), (True, False), (True, True)]


def _pair_once_sums(mxu, pos, g, m, tile, chunk, mass_grad, mask, plain):
    """The raw sums of a whole chunked pair-once backward (every self chunk
    and chunk pair, as vjp_pos_sym / vjp_pos_sym_mxu walk them): from the
    kernel, or from its plain version (B13's in bf16 mode)."""
    n = pos.shape[0]
    if mxu:
        (tile, c, nc, np_), bodies = vm.sums_inputs(pos, g, m, tile, chunk)
        ko = 9 if mass_grad else 8
    else:
        tile, c, nc, np_ = sm._resolve_tiling(n, tile, chunk, kernel=True)
        bodies = (sf._pack(pos, m, n, np_), vk._pad_rows(g, np_))
        ko = 4 if mass_grad else 3
    acc = torch.zeros((np_, ko), device=pos.device)

    def run(acc_a, acc_b, a, b, slots):
        if mxu and plain:
            vm.vjp_mxu_sums_plain(acc_a, acc_b, a[0], b[0], a[1], b[1], a[2],
                                  b[2], slots, tile, 1e-2, mask,
                                  mma_dtype=torch.bfloat16)
        elif mxu:
            vm.vjp_mxu_sums_(acc_a, acc_b, a[0], b[0], a[1], b[1], a[2],
                             b[2], slots, tile, 1e-2, mask)
        elif plain:
            vk.vjp_sym_sums_plain(acc_a, acc_b, a[0], b[0], a[1], b[1],
                                  slots, tile, 1e-2, mask)
        else:
            vk.vjp_sym_sums_(acc_a, acc_b, a[0], b[0], a[1], b[1], slots,
                             tile, 1e-2, mask)

    vk.chunk_loop(run, acc, bodies, tile, c, nc)
    return acc[:n]


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses,mass_grad", PAIR_ONCE_KINDS)
@pytest.mark.parametrize("mask", [False, True])
def test_pair_once_vjp_walk_vs_plain(cuda, mxu, tile, masses, mass_grad,
                                     mask):
    # N = 8191 (ragged) in chunks of 4096: tri and cross launches whose
    # persistent CTAs each walk several slots.
    pos, g, m = _vjp_case(8191, 75, masses, cuda)
    got, want = (_pair_once_sums(mxu, pos, g, m, tile, 4096, mass_grad,
                                 mask, plain) for plain in (False, True))
    if mxu:
        _close_cols(got, want)
    else:
        _close(got, want, 1e-3, 1e-4)


@pytest.mark.parametrize("which", sorted(ONE_SLOT))
@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses,mass_grad", PAIR_ONCE_KINDS)
@pytest.mark.parametrize("mask", [False, True])
def test_pair_once_vjp_one_slot_vs_plain(cuda, which, mxu, tile, masses,
                                         mass_grad, mask):
    # One DIAG, CROSS or FOLD slot alone, with a ragged tail and coincident
    # off-diagonal pairs: each partial tile against the plain version's
    # (B13's per column against the bf16-mode one), the rest exactly zero.
    kind, bi, bj = ONE_SLOT[which]
    n, pos, m = _one_slot_case(tile, 72, cuda, masses)
    g = _pos(n, 73, cuda)
    np_ = 4 * tile
    slots = torch.tensor([[kind, bi, bj]], dtype=torch.int32, device=cuda)
    cross = kind == sp.SLOT_CROSS
    if mxu:
        _, (p, gp, q) = vm.sums_inputs(pos, g, m, tile, chunk=np_)
        ko = 9 if mass_grad else 8
    else:
        p, gp = sf._pack(pos, m, n, np_), vk._pad_rows(g, np_)
        ko = 4 if mass_grad else 3
    got = [torch.zeros((np_, ko), device=cuda) for _ in range(1 + cross)]
    want = [torch.zeros_like(got[0]) for _ in range(1 + cross)]
    if mxu:
        vm.vjp_mxu_sums_(got[0], got[-1], p, p, gp, gp, q, q, slots, tile,
                         1e-2, mask)
        vm.vjp_mxu_sums_plain(want[0], want[-1], p, p, gp, gp, q, q, slots,
                              tile, 1e-2, mask, mma_dtype=torch.bfloat16)
    else:
        vk.vjp_sym_sums_(got[0], got[-1], p, p, gp, gp, slots, tile, 1e-2,
                         mask)
        vk.vjp_sym_sums_plain(want[0], want[-1], p, p, gp, gp, slots, tile,
                              1e-2, mask)
    tiles, rest = _side_tiles(kind, bi, bj, tile, got[0], got[-1], n)
    want_tiles, _ = _side_tiles(kind, bi, bj, tile, want[0], want[-1], n)
    for a, b in zip(tiles, want_tiles):
        if mxu:
            _close_cols(a, b)
        else:
            _close(a, b, 1e-3, 1e-4)
    for r in rest:
        assert torch.equal(r, torch.zeros_like(r))


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("masses,mass_grad", PAIR_ONCE_KINDS)
def test_pair_once_vjp_reruns_and_fast_bitwise(cuda, mxu, tile, masses,
                                               mass_grad):
    # Two runs bitwise equal, and 'fast' (the maskless body off the
    # diagonal slots) bitwise 'masked' on duplicate-free bodies.
    pos, g, m = _vjp_case(8191, 76, masses, cuda)
    assert not sm.any_coincident(pos)
    fn = vm.vjp_pos_sym_mxu if mxu else vk.vjp_pos_sym

    def run(mode):
        out = fn(pos, g, m, 1e-2, tile=tile, chunk=4096, mass_grad=mass_grad,
                 coincident=mode)
        return out if mass_grad else (out,)

    first = run("masked")
    for other in (run("masked"), run("fast")):
        for a, b in zip(first, other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("tile", [64, 128])
def test_ensemble_vjp_uneven_width_bitwise_vs_standalone(cuda, mxu, tile):
    # 7 systems of 2000: the persistent width is shared among 7 systems
    # (7 divides no width of the card), each system's CTAs walk several
    # slots, all in one launch; every system, its mass cotangent too,
    # bitwise its standalone call.
    b, n = 7, 2000
    _, st = _ensemble(n, b, True, cuda, seed=77)
    g = torch.sin(5.0 * st.pos)
    ens, one, counter = _ens_vjp(mxu)
    before = _count(counter)
    got = ens(st.pos, g, st.mass, tile=tile, mass_grad=True)
    assert _count(counter) == before + 1
    for i in range(b):
        ref = one(st.pos[i], g[i].contiguous(), st.mass[i], tile=tile,
                  mass_grad=True)
        for a, r in zip(got, ref):
            assert torch.equal(a[i], r), i


#: (occupancy query, masses, ko) of every pair-once VJP instantiation.
PAIR_ONCE_INFO = [("vjp_sym_info", 0, 3), ("vjp_sym_info", 1, 3),
                  ("vjp_sym_info", 1, 4), ("vjp_mxu_info", 0, 8),
                  ("vjp_mxu_info", 1, 8), ("vjp_mxu_info", 1, 9)]


@pytest.mark.parametrize("fn,masses,ko", PAIR_ONCE_INFO)
@pytest.mark.parametrize("tile", [64, 128])
def test_pair_once_vjp_registers_without_spills(cuda, fn, masses, ko, tile):
    # B11: (T / 4) (T / 8) threads (4 x 8 pairs each) at 16 warps per SM
    # (at most 128 registers). B13: two 16-row strips a warp (T threads) at
    # 12 warps per SM (168 registers); with the mass cotangent one strip
    # (2T threads) at 16 warps (128).
    regs, local, ctas, threads = _occupancy(fn, tile, masses, ko,
                                            threads=True)
    if fn == "vjp_sym_info":
        design, cap, warps = (tile // 4) * (tile // 8), 128, 16
    elif ko == 9:
        design, cap, warps = 2 * tile, 128, 16
    else:
        design, cap, warps = tile, 168, 12
    assert threads == design
    assert regs <= cap and local == 0 and ctas * threads // 32 >= warps


# ----------------------------------- K1, K5 and K4: the row schedule ---

def _schedules(block):
    """Every (R, rows) a launch at ``block`` rows a CTA can take."""
    return [(r, block) for r in df.ROWS_A_THREAD if block % (32 * r) == 0]


@pytest.mark.parametrize("ni,nj,softening", [
    (3001, 3001, 1e-2), (4096, 4096, 1e-2), (1000, 3001, 1e-2),
    (3001, 3001, 1e-13), (1000, 3001, 1e-13), (1000, 3001, 1e-40)])
@pytest.mark.parametrize("masses", [False, True])
def test_k1_bitwise_across_blocks_and_r(cuda, ni, nj, masses, softening):
    # One running sum per row in j order: the same bits at every block and
    # every R, in each rsqrt form (cube, normal, rsqrtf). Below FLT_MIN a
    # self pair's w overflows (NaN rows), so the rsqrtf form runs on two
    # disjoint sets.
    pj = _pos(nj, 21, cuda)
    pi = pj if ni == nj else _pos(ni, 22, cuda)
    m = torch.rand(nj, device=cuda) + 0.5 if masses else None
    want = df.body_force_direct(pi, pj, m, softening, block=128)
    for block in (128, 256, 512):
        assert torch.equal(
            df.body_force_direct(pi, pj, m, softening, block=block), want)
        for r, rows in _schedules(block):
            assert torch.equal(
                df.launch_direct(pi, pj, m, softening, r, rows), want)
    _close(want, df.direct_force_plain(pi, pj, m, softening), 1e-3, 1e-4)


@pytest.mark.parametrize("n,masses", [(1, False), (3001, True),
                                      (4096, False)])
@pytest.mark.parametrize("block", [128, 256, 512])
@pytest.mark.parametrize("softening", [1e-2, 1e-13])
def test_k5_is_k1_then_the_update(cuda, n, masses, block, softening):
    # K5's force loop is K1's: (pos', vel') bitwise K1's force followed by
    # PyTorch's v + dt F, p + dt v', at every R the launcher takes.
    pos, vel = _pos(n, 23, cuda), _pos(n, 24, cuda)
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    dt = 1e-3
    v_ref = vel + dt * df.body_force_direct(pos, pos, m, softening, block)
    p_ref = pos + dt * v_ref
    p2, v2 = df.euler_step_fused(pos, vel, m, dt, softening, block)
    assert torch.equal(v2, v_ref) and torch.equal(p2, p_ref)
    for r, rows in _schedules(block):
        p3, v3 = df.launch_fused(pos, vel, m, dt, softening, r, rows)
        assert torch.equal(v3, v_ref) and torch.equal(p3, p_ref)


@pytest.mark.parametrize("n", [3001, 4096])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("softening", [1e-2, 1e-40])
def test_k4_bitwise_across_blocks_and_r(cuda, n, masses, softening):
    # The diagonal tile apart, one running sum per row: the same row sums
    # at every block and R, in the normal and the rsqrtf form.
    pos = _pos(n, 25, cuda)
    pos[n // 2] = pos[7]  # distinct coincident bodies keep their term
    m = torch.rand(n, device=cuda) + 0.5 if masses else None
    want = pk.launch_rows(pos, m, softening, 1, 128)
    for block in (128, 256, 512):
        for r, rows in _schedules(block):
            assert torch.equal(pk.launch_rows(pos, m, softening, r, rows),
                               want)
    got = pk.potential_energy_kernel(pos, m, softening).item()
    oracle = pk.potential_energy_plain(
        pos.double(), None if m is None else m.double(), softening).item()
    assert abs(got - oracle) <= 1e-5 * abs(oracle)


@pytest.mark.parametrize("masses", [False, True])
def test_k4_rsqrtf_form_below_flt_min(cuda, masses):
    # Below FLT_MIN the host picks rsqrtf: the coincident pair's r2 is the
    # denormal softening, whose term (~1e20) rsqrt.approx.ftz would flush
    # to inf.
    soft = 1e-40
    assert df.rsqrt_form(soft, cube=False) == df.FORM_RSQRTF
    pos = _pos(64, 26, cuda)
    pos[20] = pos[10]
    m = torch.rand(64, device=cuda) + 0.5 if masses else None
    got = pk.potential_energy_kernel(pos, m, soft).item()
    oracle = pk.potential_energy_plain(
        pos.double(), None if m is None else m.double(), soft).item()
    assert abs(got - oracle) <= 1e-5 * abs(oracle)


def test_normal_forms_refused_below_their_bound(cuda):
    # The kernels refuse an rsqrt.approx.ftz form the softening does not
    # make exact; the host never asks for one.
    from mini_nbody_tpu_torch import _build

    lib = _build.load_library()
    pos = _pos(256, 27, cuda)
    out = torch.empty((256, 3), device=cuda)
    rows = torch.empty(256, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for form, soft in ((df.FORM_CUBE, 1e-14), (df.FORM_NORMAL, 1e-40)):
        assert lib.direct_force_launch(
            pos.data_ptr(), 256, pos.data_ptr(), None, 256, out.data_ptr(),
            soft, form, 1, 128, stream) != 0
    assert lib.pe_rows_launch(pos.data_ptr(), None, 256, rows.data_ptr(),
                              1e-40, 1, 1, 128, stream) != 0


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("rows", [128, 512, 1024])
@pytest.mark.parametrize("masses,form,euler", [
    (0, df.FORM_CUBE, 0), (1, df.FORM_CUBE, 0), (0, df.FORM_NORMAL, 0),
    (1, df.FORM_RSQRTF, 0), (0, df.FORM_CUBE, 1), (1, df.FORM_NORMAL, 1)])
def test_k1_k5_registers_without_spills(cuda, r, rows, masses, form, euler):
    regs, local, ctas, threads = _occupancy(
        "direct_force_info", r, rows, masses, form, euler, threads=True)
    assert threads == rows // r
    assert local == 0 and ctas >= 1 and regs <= 65536 // (rows // r)


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("rows", [128, 256, 1024])
@pytest.mark.parametrize("normal", [0, 1])
def test_k4_registers_without_spills(cuda, r, rows, normal):
    regs, local, ctas, threads = _occupancy("pe_rows_info", r, rows, normal,
                                            threads=True)
    assert threads == rows // r
    assert local == 0 and ctas >= 1
