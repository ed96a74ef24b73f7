"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mini_nbody_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, drives the main path
(``simulate`` at N = 1,048,576 on the ``sym_mxu`` and ``direct`` backends),
checks that path's forces against a float64 oracle, and times each kernel
beside its plain version. Every phase prints one line; the line before the
last is the card's name and power limit from nvidia-smi, preceded by one
JSON line of per-kernel results, and the last line is
``{"ok": true, "device": {...}}``. Any failure raises: the traceback is
printed, the exit code is non-zero and the ok line is never printed. Needs
one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mini_nbody_tpu_torch import SimConfig, _build, init, make_force_fn, simulate
from mini_nbody_tpu_torch.ops import direct_force as df
from mini_nbody_tpu_torch.ops import slot_pipe as sp
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.ops.reference import body_force_torch
from mini_nbody_tpu_torch.utils.harness import FLOPS_PER_INTERACTION, time_fn

N_MAIN = 1 << 20
#: The sym_mxu chunk of the main path (the JAX default): 8 chunks at N_MAIN.
CHUNK = 131072
N_LEAPFROG = 65536
SEED = 0

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

    df.LAUNCHES = sp.LAUNCHES = sp.CROSS_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_sym = simulate(cfg_sym, state)
    torch.cuda.synchronize()
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_dir = simulate(cfg_dir, state)
    torch.cuda.synchronize()
    t_dir = time.perf_counter() - t0
    launches = {"direct": df.LAUNCHES, "slot_tri": sp.LAUNCHES
                - sp.CROSS_LAUNCHES, "slot_cross": sp.CROSS_LAUNCHES}

    nc = -(-N_MAIN // CHUNK)
    want_tri, want_cross = 2 * nc, 2 * nc * (nc - 1) // 2
    if launches != {"direct": 1, "slot_tri": want_tri,
                    "slot_cross": want_cross}:
        fail(f"launch counts {launches}: expected direct 1, slot_tri "
             f"{want_tri}, slot_cross {want_cross}")
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
    line("main_path", n=N_MAIN, coincident_route=route,
         sym_mxu_2_steps_s=t_sym, direct_1_step_s=t_dir, launches=launches,
         sym_mxu_vs_fp64=rel_err_stats(f_sym, oracle),
         direct_vs_fp64=rel_err_stats(f_dir, oracle))
    return state, launches, k1_err, cfg_sym, cfg_dir


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
    slot_src = "mini_nbody_tpu_torch/csrc/slot_pipe.cu"
    return [
        {"name": "direct_force (K1)", "route": "cuda",
         "source": "mini_nbody_tpu_torch/csrc/direct_force.cu",
         "replaces": "mini_nbody_tpu/ops/pallas_force.py:44",
         "launches": launches["direct"], "max_abs_err": k1_err,
         "ms": k1_s * 1e3, "plain_ms": plain_s * 1e3, "plain_n": plain_n},
        {"name": "slot_pipe tri mode (K2)", "route": "cuda",
         "source": slot_src,
         "replaces": "mini_nbody_tpu/ops/slot_pipe.py:165",
         "launches": launches["slot_tri"], "max_abs_err": tri_err,
         "ms": tri_s * 1e3, "plain_ms": tri_plain_s * 1e3},
        {"name": "slot_pipe cross mode (K2)", "route": "cuda",
         "source": slot_src,
         "replaces": "mini_nbody_tpu/ops/slot_pipe.py:210",
         "launches": launches["slot_cross"], "max_abs_err": cross_err,
         "ms": cross_s * 1e3, "plain_ms": cross_plain_s * 1e3},
    ]


def main():
    smi = device_phase()
    build_phase()
    rng = np.random.default_rng(SEED)
    k1_phase(rng)
    k2_phase(rng)
    state, launches, k1_err, cfg_sym, cfg_dir = main_phase()
    leapfrog_phase()
    kernels = times_phase(state, launches, k1_err, cfg_sym, cfg_dir)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
