"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mini_nbody_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, and drives the port's paths,
each with every launch count set to 0 just before it and read just after:

- ``main_path``: ``simulate`` at N = 1,048,576 on ``sym_mxu`` and ``direct``
  (K1, K2), forces checked against a float64 oracle;
- ``auto_main_path``: ``simulate`` at N = 1,048,576 with the backend left at
  ``auto`` (K3 only);
- ``config3_drift``: the BASELINE's config 3, plummer N = 262,144 with
  masses, 1000 leapfrog steps on ``auto`` (K3), energies through K4, held
  to the drift gate 1e-5;
- ``config2_fused``: config 2, N = 65,536, 10 fused Euler steps (K5) against
  the unfused ``direct`` run.

Then it times each kernel beside its plain version and its bound. Every
phase prints one JSON line; the line before the last is the card's name
and power limit from nvidia-smi, preceded by one JSON line of per-kernel
results, and the last line is ``{"ok": true, "device": {...}}``. Any failure
raises: the traceback is printed, the exit code is non-zero and the ok line
is never printed. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mini_nbody_tpu_torch import SimConfig, _build, init, make_force_fn, simulate
from mini_nbody_tpu_torch.ops import diagnostics as dg
from mini_nbody_tpu_torch.ops import direct_force as df
from mini_nbody_tpu_torch.ops import pe_kernel as pk
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.ops import symmetric_force as sf
from mini_nbody_tpu_torch.ops.reference import body_force_torch
from mini_nbody_tpu_torch.utils.harness import FLOPS_PER_INTERACTION, time_fn

N_MAIN = 1 << 20
#: The sym_mxu and sym chunk of the main paths (the JAX default): 8 chunks
#: at N_MAIN.
CHUNK = 131072
N_LEAPFROG = 65536
#: BASELINE config 3 (plummer, masses, leapfrog, drift gate) and config 2
#: (direct kernel with the fused integrate).
N_CONFIG3, STEPS_CONFIG3, DRIFT_GATE = 262144, 1000, 1e-5
N_CONFIG2, STEPS_CONFIG2 = 65536, 10
#: Fail before the 1000 steps of config 3 if one step says they would take
#: longer than this.
CONFIG3_MAX_S = 600.0
SEED = 0

#: H100 SXM peaks (NVIDIA's published figures): fp32 outside the
#: tensor cores, dense bf16 on the tensor cores, device memory.
PEAK_FP32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
#: fp32 operations per pair for the bounds: an ordered interaction is 20 (the
#: repo's convention, harness.py); a pair-once evaluation computes w once
#: (12, the rsqrt counted as 1) and sums both sides (6 each, +1 each with a
#: mass); K2 computes w (12) in fp32 and its sums on the tensor cores (two
#: sides x 8 columns x 2); the potential is 12 per ordered pair.
OPS_ORDERED, OPS_PAIR_ONCE, OPS_PAIR_ONCE_MASS = 20, 24, 26
OPS_K2_FP32, OPS_K2_MMA, OPS_PE = 12, 32, 12
#: K5's epilogue per body: v' = v + dt F and p' = p + dt v'.
OPS_EULER = 12

#: K1 vs its plain version and vs the fp64 oracle: fp32 sums of up to 2^20
#: terms in different orders (and FMA contraction in the kernel) drift by
#: ~sqrt(N) * 2^-24 of the partial sums, ~6e-5 of the largest force.
K1_RTOL, K1_ATOL = 1e-3, 1e-4
#: K2 raw sums vs the bf16-mode plain sums, per column scale: both round w
#: and v to bf16 the same way, but FMA contraction can move a w across a
#: bf16 rounding boundary (one pair term off by 2^-8), and the atomics sum
#: in another order.
K2_ATOL = 2e-3
#: sym_mxu forces vs the fp64 oracle: the on-card bf16-accumulate bound of
#: tests/test_slot_pipe.py:24.
SYM_RTOL, SYM_ATOL = 2e-2, 5e-3
#: K3 vs its plain version: fp32 sums in another order plus atomics, the K1
#: bound. K4's U against its plain version and a float64 oracle.
K3_RTOL, K3_ATOL = K1_RTOL, K1_ATOL
K4_RTOL = 1e-5
#: K5 (fused) against the unfused direct run: the epilogue rounds as the
#: unfused PyTorch update does and the force loop is K1's. Against its plain
#: version K5 is held to K1's bound.
K5_RTOL, K5_ATOL = 1e-4, 1e-5
#: Time the plain version at N_MAIN only if 16x its time at N_MAIN / 4 fits.
PLAIN_MAX_S = 60.0

DEV = torch.device("cuda", 0)


def fail(msg):
    raise RuntimeError(msg)


def line(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def close(got, want, rtol, atol_scale, what):
    """Raise unless |got - want| <= rtol |want| + atol_scale * max|want|;
    returns the max abs error."""
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    scale = max(want.abs().max().item(), 1.0)
    err = (got - want).abs()
    bad = err > rtol * want.abs() + atol_scale * scale
    if bad.any():
        fail(f"{what}: {int(bad.sum())} elements out of bound, max err "
             f"{err.max().item():.4g}, scale {scale:.4g}")
    return err.max().item()


def close_cols(got, want, atol, what):
    """Raw-sum check: per column, |got - want| <= atol * max|want[:, col]|."""
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    err = (got - want).abs()
    if (err > atol * scale).any():
        fail(f"{what}: max err/col scale {(err / scale).max().item():.4g}")
    return err.max().item()


#: Launch counters of every kernel wrapper: name -> (module, attribute).
COUNTERS = {"direct": (df, "LAUNCHES"), "fused": (df, "FUSED_LAUNCHES"),
            "slot": (sp, "LAUNCHES"), "slot_cross": (sp, "CROSS_LAUNCHES"),
            "sym": (sf, "LAUNCHES"), "sym_cross": (sf, "CROSS_LAUNCHES"),
            "pe": (pk, "LAUNCHES")}


def reset_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts():
    """Launches per kernel (tri and cross modes apart) since reset_counts."""
    c = {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}
    return {"direct": c["direct"], "fused_euler": c["fused"],
            "slot_tri": c["slot"] - c["slot_cross"],
            "slot_cross": c["slot_cross"],
            "sym_tri": c["sym"] - c["sym_cross"], "sym_cross": c["sym_cross"],
            "pe": c["pe"]}


def expect_counts(got, path, **want):
    """Fail unless the path launched exactly ``want`` and nothing else."""
    full = dict.fromkeys(got, 0)
    full.update(want)
    if got != full:
        fail(f"{path}: launch counts {got}, expected {full}")


def bound(fp32_ops, nbytes, bf16_ops=0.0):
    """The least time the card could take: the larger of the operations
    over their peak rates and the bytes over the memory rate."""
    t_ops = fp32_ops / PEAK_FP32 + bf16_ops / PEAK_BF16
    t_bytes = nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def entry(name, source, replaces, launches, err, ms, plain_ms, bnd, **kw):
    """One record of the kernels line (no single PyTorch call computes any
    of these functions, so library_ms is null)."""
    return {"name": name, "route": "cuda",
            "source": f"mini_nbody_tpu_torch/csrc/{source}",
            "replaces": f"mini_nbody_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None, **kw}


def host_time(fn, *args):
    """Seconds of one call of fn, synchronized; returns (seconds, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def device_phase():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)
    return smi


def build_phase():
    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    line("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.BUILD_SECONDS, ptxas=ptxas)


def k1_phase(rng):
    """K1 vs direct_force_plain on the card."""
    cases = [(1, 1, False), (1, 1, True), (1000, 1000, False),
             (1000, 1000, True), (4096, 4096, False), (4096, 4096, True),
             (1000, 3000, True)]
    errs = []
    for ni, nj, mass in cases:
        pj = torch.from_numpy(rng.uniform(-1, 1, (nj, 3)).astype(np.float32))
        pi = pj[:ni] if ni == nj else torch.from_numpy(
            rng.uniform(-1, 1, (ni, 3)).astype(np.float32))
        pi, pj = pi.contiguous().to(DEV), pj.to(DEV)
        m = (torch.from_numpy(rng.uniform(0.5, 2.0, nj).astype(np.float32))
             .to(DEV) if mass else None)
        got = df.body_force_direct(pi, pj, m)
        want = df.direct_force_plain(pi, pj, m)
        torch.cuda.synchronize()
        if ni == 1 and nj == 1 and got.abs().max().item() != 0.0:
            fail("K1: N=1 self force is not exactly 0")
        errs.append(close(got, want, K1_RTOL, K1_ATOL,
                          f"K1 ni={ni} nj={nj} mass={mass}"))
    line("k1_vs_plain", cases=len(cases), max_abs_err=max(errs))


def k2_phase(rng):
    """K2 vs the bf16-mode plain sums, N = 3000, tile 128, chunk 1024."""
    n, tile, chunk = 3000, 128, 1024
    tile, c, nc, np_ = sm._resolve_tiling(n, tile, chunk, kernel=True)
    pos = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    mass = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    errs = []
    for masses in (False, True):
        p, v = sm._pack(pos.to(DEV), mass.to(DEV) if masses else None, n,
                        np_)
        last = slice((nc - 1) * c, nc * c)  # holds the ragged tail
        real = n - (nc - 1) * c
        for fold in (False, True):
            for mask in (False, True):
                got = sp.build_tri_slot_call(1e-9, tile, c, mask_offdiag=mask,
                                             fold=fold)(p[last], v[last])
                want = sp.tri_slot_sums_plain(
                    p[last], v[last], 1e-9, tile, fold=fold,
                    mask_offdiag=mask, mma_dtype=torch.bfloat16)
                errs.append(close_cols(
                    got.T[:real], want.T[:real], K2_ATOL,
                    f"K2 tri masses={masses} fold={fold} mask={mask}"))
        for mask in (False, True):
            got = sp.build_cross_slot_call(1e-9, tile, c, mask=mask)(
                p[:c], p[last], v[:c], v[last])
            want = sp.cross_slot_sums_plain(
                p[:c], p[last], v[:c], v[last], 1e-9, tile, mask=mask,
                mma_dtype=torch.bfloat16)
            errs.append(close_cols(got[0].T, want[0].T, K2_ATOL,
                                   f"K2 cross rows masses={masses}"))
            errs.append(close_cols(got[1].T[:real], want[1].T[:real],
                                   K2_ATOL, f"K2 cross cols masses={masses}"))
    torch.cuda.synchronize()

    # Duplicate bodies under coincident='auto' (N >= COINCIDENT_AUTO_MIN_N,
    # so the duplicate scan runs): the scan must route to the masked kernel,
    # and a cloud of 8192 copies of one point has exactly zero force.
    nd = sm.COINCIDENT_AUTO_MIN_N
    dup = torch.full((nd, 3), 0.25, device=DEV)
    if not sm.any_coincident(dup):
        fail("any_coincident missed exact duplicates")
    f_dup = sm.body_force_sym_mxu(dup, coincident="auto")
    torch.cuda.synchronize()
    if f_dup.abs().max().item() != 0.0:
        fail("duplicate bodies: mutual force is not exactly 0")
    # Two duplicate pairs inside a random cloud: close to the fp64 oracle.
    cloud = torch.from_numpy(rng.uniform(-1, 1, (nd, 3)).astype(np.float32))
    cloud[4000] = cloud[5]
    cloud[7000] = cloud[7]
    cloud = cloud.to(DEV)
    route = ("masked" if sm.any_coincident(cloud) else "maskless")
    f = sm.body_force_sym_mxu(cloud, coincident="auto")
    want = body_force_torch(cloud.double(), cloud.double(), row_chunk=512)
    close(f, want, SYM_RTOL, SYM_ATOL, "sym_mxu with duplicates")
    line("k2_vs_plain", cases=len(errs), max_abs_err=max(errs),
         duplicate_route=route, duplicate_cloud_force=0.0)


def k3_phase(rng):
    """K3 vs symmetric_sums_plain on the card: tri (fold on and off) and
    cross modes, unit and mass mode, at the ragged N = 3000, chunk 1024;
    the whole force against the fp64 oracle; body_force_pair with unequal
    lengths; N = 1 and zero masses exactly 0."""
    n, chunk, soft = 3000, 1024, 1e-9
    pos = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)
                           ).to(DEV)
    mass = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)
                            ).to(DEV)
    tile, c, nc, np_ = sm._resolve_tiling(n, sf.DEFAULT_TILE, chunk,
                                          kernel=True)
    nb = c // tile
    last = slice((nc - 1) * c, nc * c)  # holds the ragged tail
    errs = []
    for m in (None, mass):
        p = sf._pack(pos, m, n, np_)
        what = f"masses={m is not None}"
        for fold in (False, True):
            slots = sp.slot_table(nb, fold, False, DEV)
            got, want = (torch.zeros((c, 3), device=DEV) for _ in range(2))
            sf.symmetric_sums_(got, got, p[last], p[last], slots, tile, soft)
            sf.symmetric_sums_plain(want, want, p[last], p[last], slots,
                                    tile, soft)
            errs.append(close(got, want, K3_RTOL, K3_ATOL,
                              f"K3 tri fold={fold} {what}"))
        slots = sp.slot_table(nb, False, True, DEV)
        ga, gb, wa, wb = (torch.zeros((c, 3), device=DEV) for _ in range(4))
        sf.symmetric_sums_(ga, gb, p[:c], p[last], slots, tile, soft)
        sf.symmetric_sums_plain(wa, wb, p[:c], p[last], slots, tile, soft)
        errs.append(close(ga, wa, K3_RTOL, K3_ATOL, f"K3 cross rows {what}"))
        errs.append(close(gb, wb, K3_RTOL, K3_ATOL, f"K3 cross cols {what}"))
        f = sf.body_force_symmetric(pos, m, softening=soft, chunk=chunk)
        oracle = body_force_torch(pos.double(), pos.double(),
                                  None if m is None else m.double(),
                                  softening=soft, row_chunk=512)
        close(f, oracle, K3_RTOL, K3_ATOL, f"K3 force vs fp64 {what}")
    pa, pb = pos[:700], pos[700:2000] + 3.0
    fa, fb = sf.body_force_pair(pa, pb, mass[:700], mass[700:2000])
    close(fa, body_force_torch(pa.double(), pb.double(),
                               mass[700:2000].double()),
          K3_RTOL, K3_ATOL, "body_force_pair rows")
    close(fb, body_force_torch(pb.double(), pa.double(), mass[:700].double()),
          K3_RTOL, K3_ATOL, "body_force_pair reactions")
    one = sf.body_force_symmetric(pos[:1].contiguous())
    inert = sf.body_force_symmetric(pos, torch.zeros_like(mass), chunk=chunk)
    torch.cuda.synchronize()
    if one.abs().max().item() != 0.0:
        fail("K3: N=1 self force is not exactly 0")
    if inert.abs().max().item() != 0.0:
        fail("K3: zero masses are not exactly inert")
    line("k3_vs_plain", cases=len(errs), max_abs_err=max(errs), n=n,
         chunk=chunk, tile=tile)


def k3_sums(p, c, tile, soft, slots, cross, plain=False):
    """One K3 launch, or its plain version, on packed bodies p: the self
    chunk 0 (tri mode) or the chunk pair (0, 1) (cross mode); returns the
    sums, rows then reactions in cross mode."""
    a = p[:c]
    b = p[c:2 * c] if cross else a
    acc_a = torch.zeros((c, 3), device=DEV)
    acc_b = torch.zeros((c, 3), device=DEV) if cross else acc_a
    run = sf.symmetric_sums_plain if plain else sf.symmetric_sums_
    run(acc_a, acc_b, a, b, slots, tile, soft)
    return torch.cat([acc_a, acc_b]) if cross else acc_a


def k3_slots(c, tile):
    """The slot tables of the path at chunk c: tri (fold) and cross."""
    nb = c // tile
    return {"tri": sp.slot_table(nb, True, False, DEV),
            "cross": sp.slot_table(nb, False, True, DEV)}


def k3_check(p, c, tile, soft, what):
    """One tri and one cross launch of K3 on packed p, each held against
    the plain version on the same inputs: {mode: (plain seconds, max abs
    error)}."""
    out = {}
    for mode, slots in k3_slots(c, tile).items():
        cross = mode == "cross"
        plain_s, want = host_time(k3_sums, p, c, tile, soft, slots, cross,
                                  True)
        got = k3_sums(p, c, tile, soft, slots, cross)
        out[mode] = (plain_s, close(got, want, K3_RTOL, K3_ATOL,
                                    f"K3 {mode} {what} at c={c}"))
    return out


def k4_phase(rng):
    """K4's U vs its plain version and a float64 oracle, |dU| <= 1e-5 |U|:
    N = 4096 and the ragged 3001, with and without masses, and two distinct
    coincident bodies whose eps^-1/2 term must stay."""
    cases = []
    for n, soft in ((4096, 1e-2), (3001, 1e-9), (64, 1e-6)):
        pos = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
        if n == 64:  # the pair term is ~1000, ~40% of |U|
            pos[20] = pos[10]
        mass = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
        cases += [(pos.to(DEV), m, soft) for m in (None, mass.to(DEV))]
    worst = 0.0
    for pos, m, soft in cases:
        got = pk.potential_energy_kernel(pos, m, soft).item()
        plain = pk.potential_energy_plain(pos, m, soft).item()
        oracle = pk.potential_energy_plain(
            pos.double(), None if m is None else m.double(), soft).item()
        for want, what in ((plain, "plain"), (oracle, "fp64 oracle")):
            rel = abs(got - want) / abs(want)
            if not rel <= K4_RTOL:
                fail(f"K4 vs {what}: n={pos.shape[0]} masses={m is not None} "
                     f"U={got!r} want {want!r} rel {rel:.3g}")
            worst = max(worst, rel)
    line("k4_vs_plain", cases=len(cases), max_rel_err=worst)


def rel_err_stats(got, want):
    rel = ((got.double() - want).norm(dim=1)
           / want.norm(dim=1).clamp_min(1e-30))
    return {"median_rel_err": rel.median().item(),
            "p99_rel_err": torch.quantile(rel, 0.99).item()}


def main_phase():
    """simulate at N_MAIN through the kernels; launch counts; fp64 check."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    state = init.uniform_random(N_MAIN, generator=gen, device=DEV)
    cfg_sym = SimConfig(n=N_MAIN, steps=2, backend="sym_mxu",
                        integrator="euler", sym_chunk=CHUNK)
    cfg_dir = SimConfig(n=N_MAIN, steps=1, backend="direct",
                        integrator="euler")
    route = sm.resolve_auto(cfg_sym.coincident, N_MAIN)
    if route == "auto":
        route = "masked" if sm.any_coincident(state.pos) else "maskless"

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_sym = simulate(cfg_sym, state)
    torch.cuda.synchronize()
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_dir = simulate(cfg_dir, state)
    torch.cuda.synchronize()
    t_dir = time.perf_counter() - t0
    launches = read_counts()

    nc = -(-N_MAIN // CHUNK)
    expect_counts(launches, "main_path", direct=1, slot_tri=2 * nc,
                  slot_cross=2 * nc * (nc - 1) // 2)
    for name, s in (("sym_mxu", out_sym), ("direct", out_dir)):
        for t in (s.pos, s.vel):
            if t.shape != (N_MAIN, 3) or not torch.isfinite(t).all():
                fail(f"{name}: non-finite or misshapen state")

    # Forces of the initial state on 1024 random rows vs a float64 oracle
    # over all N_MAIN sources.
    idx = torch.randperm(N_MAIN, generator=gen, device=DEV)[:1024]
    oracle = body_force_torch(state.pos[idx].double(), state.pos.double(),
                              row_chunk=16)
    f_sym = make_force_fn(cfg_sym)(state.pos, state.pos)[idx]
    f_dir = make_force_fn(cfg_dir)(state.pos, state.pos)[idx]
    f_dir_plain = df.direct_force_plain(state.pos[idx].contiguous(),
                                        state.pos)
    torch.cuda.synchronize()
    close(f_sym, oracle, SYM_RTOL, SYM_ATOL, "sym_mxu vs fp64 oracle")
    close(f_dir, oracle, K1_RTOL, K1_ATOL, "direct vs fp64 oracle")
    k1_err = close(f_dir, f_dir_plain, K1_RTOL, K1_ATOL,
                   "direct vs plain at N=2^20")
    dir_stats = rel_err_stats(f_dir, oracle)
    line("main_path", n=N_MAIN, coincident_route=route,
         sym_mxu_2_steps_s=t_sym, direct_1_step_s=t_dir, launches=launches,
         sym_mxu_vs_fp64=rel_err_stats(f_sym, oracle),
         direct_vs_fp64=dir_stats)
    return state, launches, k1_err, cfg_sym, cfg_dir, (idx, oracle, dir_stats)


def leapfrog_phase():
    n = N_LEAPFROG
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    state = init.uniform_random(n, generator=gen, device=DEV)
    t0 = time.perf_counter()
    out = simulate(SimConfig(n=n, steps=5, backend="sym_mxu",
                             integrator="leapfrog"), state)
    torch.cuda.synchronize()
    if not (torch.isfinite(out.pos).all() and torch.isfinite(out.vel).all()):
        fail("leapfrog: non-finite state")
    line("leapfrog", n=n, steps=5, seconds=time.perf_counter() - t0)


def auto_phase(state, check):
    """simulate at N_MAIN with the backend left at 'auto': K3 only, and
    its forces on the main path's rows vs the fp64 oracle."""
    idx, oracle, dir_stats = check
    cfg = SimConfig(n=N_MAIN, steps=1)
    reset_counts()
    step_s, out = host_time(simulate, cfg, state)
    launches = read_counts()
    nc = -(-N_MAIN // CHUNK)
    expect_counts(launches, "auto_main_path", sym_tri=nc,
                  sym_cross=nc * (nc - 1) // 2)
    for t in (out.pos, out.vel):
        if t.shape != (N_MAIN, 3) or not torch.isfinite(t).all():
            fail("auto: non-finite or misshapen state")
    f = make_force_fn(cfg)(state.pos, state.pos)[idx]
    close(f, oracle, K1_RTOL, K1_ATOL, "sym (auto) vs fp64 oracle")
    line("auto_main_path", n=N_MAIN, backend=cfg.effective_backend(),
         euler_1_step_s=step_s, launches=launches,
         sym_vs_fp64=rel_err_stats(f, oracle), direct_vs_fp64=dir_stats)
    return cfg, launches


def config3_phase():
    """BASELINE config 3 on the default path: plummer with masses, N =
    262,144, softening 1e-2, dt 1e-3, 1000 leapfrog steps on 'auto' (K3),
    E0 and E1 through total_energy (K4); fails above the drift gate. K3's
    mass mode is first held against its plain version at this chunk."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    state = init.plummer(N_CONFIG3, generator=gen, device=DEV)
    cfg = SimConfig(n=N_CONFIG3, steps=STEPS_CONFIG3, dt=1e-3,
                    softening=1e-2, integrator="leapfrog", use_masses=True)
    # One step (two force passes: the initial one and the step's) first.
    probe_s, _ = host_time(simulate, cfg, state, 1)
    estimate_s = probe_s * (STEPS_CONFIG3 + 1) / 2
    if estimate_s > CONFIG3_MAX_S:
        fail(f"config3: one step took {probe_s:.3f} s, so {STEPS_CONFIG3} "
             f"steps would take ~{estimate_s:.0f} s")
    # K3's mass-mode build at this path's chunk vs its plain version, with
    # the state's equal masses and with unequal ones (which tell m_i from
    # m_j in the row and reaction sums).
    tile, c, _, np_ = sm._resolve_tiling(N_CONFIG3, sf.DEFAULT_TILE, CHUNK,
                                         kernel=True)
    unequal = state.mass * torch.empty_like(state.mass).uniform_(
        0.5, 2.0, generator=gen)
    k3 = {what: {mode: err for mode, (_, err) in k3_check(
              sf._pack(state.pos, m, N_CONFIG3, np_), c, tile,
              cfg.softening, f"{what} masses").items()}
          for what, m in (("state", state.mass), ("unequal", unequal))}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0 = dg.total_energy(state, cfg.softening)
    out = simulate(cfg, state)
    e1 = dg.total_energy(out, cfg.softening)
    drift = dg.energy_drift(e0, e1).item()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    passes = STEPS_CONFIG3 + 1
    nc = -(-N_CONFIG3 // CHUNK)
    expect_counts(launches, "config3_drift", sym_tri=nc * passes,
                  sym_cross=nc * (nc - 1) // 2 * passes, pe=2)
    dg.assert_finite(out, "after config 3")
    if not drift <= DRIFT_GATE:
        fail(f"config3: energy drift {drift:.3g} > {DRIFT_GATE}")
    line("config3_drift", n=N_CONFIG3, steps=STEPS_CONFIG3, drift=drift,
         e0=e0.item(), e1=e1.item(), pe_launches=launches["pe"],
         launches=launches, seconds=seconds, one_step_probe_s=probe_s,
         momentum_after=dg.momentum(out).tolist(), k3_mass_chunk=c,
         k3_mass_vs_plain_max_abs_err=k3)
    return state, launches


def config2_phase():
    """BASELINE config 2: N = 65,536, 10 fused Euler steps (K5) on the
    direct backend, against the unfused direct run."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    state = init.uniform_random(N_CONFIG2, generator=gen, device=DEV)
    cfg = SimConfig(n=N_CONFIG2, steps=STEPS_CONFIG2, backend="direct",
                    fused_integrate=True)
    reset_counts()
    fused_s, out = host_time(simulate, cfg, state)
    launches = read_counts()
    expect_counts(launches, "config2_fused", fused_euler=STEPS_CONFIG2)
    unfused_s, ref = host_time(simulate, cfg.replace(fused_integrate=False),
                               state)
    err = max(close(out.pos, ref.pos, K5_RTOL, K5_ATOL, "K5 pos vs unfused"),
              close(out.vel, ref.vel, K5_RTOL, K5_ATOL, "K5 vel vs unfused"))
    line("config2_fused", n=N_CONFIG2, steps=STEPS_CONFIG2,
         launches=launches, fused_s=fused_s, unfused_s=unfused_s,
         max_abs_err=err, bitwise=bool(torch.equal(out.pos, ref.pos)
                                       and torch.equal(out.vel, ref.vel)))
    return state, launches


def gips(n, seconds):
    return float(n) ** 2 / seconds / 1e9


def times_phase(state, launches, k1_err, cfg_sym, cfg_dir):
    """Each kernel beside its plain version at the main path's shapes;
    returns the per-kernel records of the kernels line."""
    pos = state.pos
    k1_s = time_fn(make_force_fn(cfg_dir), pos, pos, reps=3)
    small = pos[:N_MAIN // 4].contiguous()
    plain_small_s = time_fn(df.direct_force_plain, small, small, reps=1)
    if 16 * plain_small_s <= PLAIN_MAX_S:
        plain_n, plain_s = N_MAIN, time_fn(df.direct_force_plain, pos, pos,
                                           reps=1, warmup=0)
    else:
        plain_n, plain_s = N_MAIN // 4, plain_small_s
    line("time_direct", n=N_MAIN, kernel_ms=k1_s * 1e3,
         kernel_ginter_s=gips(N_MAIN, k1_s),
         kernel_gflops_20=gips(N_MAIN, k1_s) * FLOPS_PER_INTERACTION,
         plain_n=plain_n, plain_ms=plain_s * 1e3,
         plain_ginter_s=gips(plain_n, plain_s))

    # One tri launch (chunk 0) and one cross launch (chunks 0, 1) at the
    # main path's chunk and tile, maskless (no duplicates), fold.
    tile, c, nc, np_ = sm._resolve_tiling(N_MAIN, sm.DEFAULT_TILE, CHUNK,
                                          kernel=True)
    p, v = sm._pack(pos, None, N_MAIN, np_)
    a, b = slice(0, c), slice(c, 2 * c)
    tri = sp.build_tri_slot_call(cfg_sym.softening, tile, c,
                                 mask_offdiag=False)
    cross = sp.build_cross_slot_call(cfg_sym.softening, tile, c, mask=False)
    tri_s = time_fn(tri, p[a], v[a], reps=3)
    cross_s = time_fn(cross, p[a], p[b], v[a], v[b], reps=3)
    tri_got, cross_got = tri(p[a], v[a]), cross(p[a], p[b], v[a], v[b])
    t0 = time.perf_counter()
    tri_want = sp.tri_slot_sums_plain(p[a], v[a], cfg_sym.softening, tile,
                                      mask_offdiag=False,
                                      mma_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    tri_plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cross_want = sp.cross_slot_sums_plain(p[a], p[b], v[a], v[b],
                                          cfg_sym.softening, tile, mask=False,
                                          mma_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cross_plain_s = time.perf_counter() - t0
    tri_err = close_cols(tri_got.T, tri_want.T, K2_ATOL, f"K2 tri at c={c}")
    cross_err = max(close_cols(g.T, w.T, K2_ATOL, f"K2 cross at c={c}")
                    for g, w in zip(cross_got, cross_want))
    pass_s = time_fn(make_force_fn(cfg_sym), pos, pos, reps=3)
    line("time_sym_mxu", n=N_MAIN, chunk=c, tile=tile,
         tri_launch_ms=tri_s * 1e3, tri_plain_ms=tri_plain_s * 1e3,
         cross_launch_ms=cross_s * 1e3, cross_plain_ms=cross_plain_s * 1e3,
         pass_ms=pass_s * 1e3, pass_ginter_s=gips(N_MAIN, pass_s),
         plain_pass_ms_from_launches=(nc * tri_plain_s + nc * (nc - 1) // 2
                                      * cross_plain_s) * 1e3)
    n = float(N_MAIN)
    tri_pairs, cross_pairs = c * (c - 1) / 2, float(c) * c
    k2_bytes = (2 * c * 3 + 2 * c * 8 + 2 * c * 8) * 4.0  # pos, v in; acc out
    return [
        entry("direct_force (K1)", "direct_force.cu", "pallas_force.py:44",
              launches["direct"], k1_err, k1_s * 1e3, plain_s * 1e3,
              bound(n * (n - 1) * OPS_ORDERED, n * 6 * 4), n=N_MAIN,
              plain_n=plain_n),
        entry("slot_pipe tri mode (K2)", "slot_pipe.cu", "slot_pipe.py:165",
              launches["slot_tri"], tri_err, tri_s * 1e3, tri_plain_s * 1e3,
              bound(tri_pairs * OPS_K2_FP32, k2_bytes / 2,
                    tri_pairs * OPS_K2_MMA), chunk=c),
        entry("slot_pipe cross mode (K2)", "slot_pipe.cu",
              "slot_pipe.py:210", launches["slot_cross"], cross_err,
              cross_s * 1e3, cross_plain_s * 1e3,
              bound(cross_pairs * OPS_K2_FP32, k2_bytes,
                    cross_pairs * OPS_K2_MMA), chunk=c),
    ]


def time_k3(state, launches, cfg_auto):
    """One K3 tri launch (chunk 0, fold) and one cross launch (chunks 0, 1)
    at the auto path's chunk and tile, unit masses, beside the plain slot
    walk; and a whole pass at N_MAIN."""
    soft = cfg_auto.softening
    tile, c, nc, np_ = sm._resolve_tiling(N_MAIN, sf.DEFAULT_TILE, CHUNK,
                                          kernel=True)
    p = sf._pack(state.pos, None, N_MAIN, np_)
    slots = k3_slots(c, tile)
    tri_s = time_fn(k3_sums, p, c, tile, soft, slots["tri"], False, reps=3)
    cross_s = time_fn(k3_sums, p, c, tile, soft, slots["cross"], True,
                      reps=3)
    k3 = k3_check(p, c, tile, soft, "unit masses")
    (tri_plain_s, tri_err), (cross_plain_s, cross_err) = (k3["tri"],
                                                          k3["cross"])
    pass_s = time_fn(make_force_fn(cfg_auto), state.pos, state.pos, reps=3)
    line("time_sym", n=N_MAIN, chunk=c, tile=tile,
         tri_launch_ms=tri_s * 1e3, tri_plain_ms=tri_plain_s * 1e3,
         cross_launch_ms=cross_s * 1e3, cross_plain_ms=cross_plain_s * 1e3,
         pass_ms=pass_s * 1e3, pass_ginter_s=gips(N_MAIN, pass_s),
         pass_bound_ms=bound(N_MAIN * (N_MAIN - 1) / 2 * OPS_PAIR_ONCE,
                             N_MAIN * 6 * 4.0)["bound_ms"],
         plain_pass_ms_from_launches=(nc * tri_plain_s + nc * (nc - 1) // 2
                                      * cross_plain_s) * 1e3)
    tri_pairs, cross_pairs = c * (c - 1) / 2, float(c) * c
    return [
        entry("symmetric_force tri mode (K3)", "symmetric_force.cu",
              "symmetric_force.py:107", launches["sym_tri"], tri_err,
              tri_s * 1e3, tri_plain_s * 1e3,
              bound(tri_pairs * OPS_PAIR_ONCE, c * 6 * 4.0), chunk=c),
        entry("symmetric_force cross mode (K3)", "symmetric_force.cu",
              "symmetric_force.py:155", launches["sym_cross"], cross_err,
              cross_s * 1e3, cross_plain_s * 1e3,
              bound(cross_pairs * OPS_PAIR_ONCE, c * 12 * 4.0), chunk=c),
    ]


def time_k4(state3, state_main, launches):
    """K4 at config 3's N (its path, masses) beside the plain version and
    the bound, and at N_MAIN (the plain version is not run there)."""
    soft = 1e-2
    n = float(N_CONFIG3)
    k4_s = time_fn(pk.potential_energy_kernel, state3.pos, state3.mass, soft,
                   reps=3)
    got = pk.potential_energy_kernel(state3.pos, state3.mass, soft)
    plain_s, want = host_time(pk.potential_energy_plain, state3.pos,
                              state3.mass, soft)
    err = abs(got.item() - want.item())
    if not err <= K4_RTOL * abs(want.item()):
        fail(f"K4 at N={N_CONFIG3}: U {got.item()!r} vs plain {want.item()!r}")
    main_s = time_fn(pk.potential_energy_kernel, state_main.pos,
                     state_main.mass, soft, reps=3)
    nm = float(N_MAIN)
    line("time_pe", n=N_CONFIG3, kernel_ms=k4_s * 1e3, plain_ms=plain_s * 1e3,
         n_main=N_MAIN, kernel_main_ms=main_s * 1e3,
         bound_main_ms=bound(nm * (nm - 1) * OPS_PE, nm * 20.0)["bound_ms"])
    return [entry("pe_kernel (K4)", "pe_kernel.cu", "pe_kernel.py:31",
                  launches["pe"], err, k4_s * 1e3, plain_s * 1e3,
                  bound(n * (n - 1) * OPS_PE, n * 20.0), n=N_CONFIG3)]


def time_k5(state2, launches):
    """K5 at config 2's N and block, held against its plain version on the
    same inputs at K1's bound, beside the plain version's time and the
    bound."""
    n = float(N_CONFIG2)
    block = SimConfig(n=N_CONFIG2).tile_i
    args = (state2.pos, state2.vel, None, 0.01, 1e-9)
    k5_s = time_fn(df.euler_step_fused, *args, block, reps=3)
    plain_s, want = host_time(df.euler_step_fused_plain, *args)
    got = df.euler_step_fused(*args, block)
    err = max(close(g, w, K1_RTOL, K1_ATOL, f"K5 {what} vs plain")
              for g, w, what in zip(got, want, ("pos", "vel")))
    line("time_fused_euler", n=N_CONFIG2, block=block, kernel_ms=k5_s * 1e3,
         plain_ms=plain_s * 1e3, max_abs_err=err)
    return [entry("direct_force fused Euler (K5)", "direct_force.cu",
                  "pallas_force.py:92", launches["fused_euler"], err,
                  k5_s * 1e3, plain_s * 1e3,
                  bound(n * (n - 1) * OPS_ORDERED + n * OPS_EULER,
                        n * 12 * 4.0), n=N_CONFIG2)]


def main():
    smi = device_phase()
    build_phase()
    rng = np.random.default_rng(SEED)
    k1_phase(rng)
    k2_phase(rng)
    k3_phase(rng)
    k4_phase(rng)
    state, launches, k1_err, cfg_sym, cfg_dir, check = main_phase()
    cfg_auto, auto_launches = auto_phase(state, check)
    leapfrog_phase()
    state3, c3_launches = config3_phase()
    state2, c2_launches = config2_phase()
    kernels = (times_phase(state, launches, k1_err, cfg_sym, cfg_dir)
               + time_k3(state, auto_launches, cfg_auto)
               + time_k4(state3, state, c3_launches)
               + time_k5(state2, c2_launches))
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']} was never launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
