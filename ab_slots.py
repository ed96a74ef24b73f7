"""Times the register-body kernels K3, K2, B6, B16, B14, B10, B11, B13,
B12, K1, K5 and K4 and the slot-order reduce of two trees of this repo on
one card, in turns, on the same inputs, and prints digests of their outputs.

    python3 ab_slots.py --other DIR [--turns other,this,this,other]
                        [--only slots,band,passes,b15,b6,vjp,rollout,
                                pvjp,bwdmax,b12,reduce,direct,pe]
                        [--sass-dir DIR]

DIR is another checkout of the repo (for example the parent commit unpacked
with ``git archive``, in a directory that .gitignore lists). Each turn runs
one worker process with that tree's ``mini_nbody_tpu_torch`` first on
``sys.path``; the worker builds the tree's kernels from its own sources and
prints one JSON line. Its sections (``--only`` runs some of them):
- slots: per kernel (K3 and K2, tri and cross mode, N = 2^20's chunk
  131,072 at tile 128, unit masses; K2 maskless, and masked as 'auto' runs
  it): the kernel launches of one call alone (no slot_reduce), their ms per
  launch, and the error of the (maskless) call's sums against the tree's
  plain version (K3 per element at the K1 bound's scale, K2 per column scale
  against the bf16-mode plain sums);
- band: B16 (``traversal='band'``), one tri and one cross launch at chunk
  131,072, tile 128, unit masses, maskless and masked (no slot_reduce), the
  tri launch over the first 1, 2, ... SMs' worth of row blocks (what a
  partial last wave of CTAs costs);
- passes: the ms of a whole N = 2^20 force pass on ``auto`` (K3),
  ``sym_mxu`` (K2), ``mxu`` with pair_dtype "bfloat16" (B6) and the band
  (B16);
- b15: B15 on config 1 (N = 4096, 10 Euler steps, dt 0.01) in both classes,
  ms per launch, and a leapfrog and a Yoshida-4 call of config 1's N and
  steps, with digests; a step at N = 16,384 in both classes (a 20-step
  call); the
  fixed cost of a resident Euler ``simulate`` call at N = 512 in both
  classes (calls of 2 and of 20 steps), with torch.profiler's CPU
  operators and the kernel's device time per call;
- b6: B6's bf16 class, one launch at config 3's N = 262,144 (plummer,
  masses, softening 1e-2) on the route 'auto' takes there (the overlap run
  after the duplicate scan);
- vjp: on the same plummer bodies with a normal cotangent, B14 (one square
  launch, tile 128, with masses under 'fast' and 'masked', with unit masses
  under 'fast') and B10 (one square launch, masses, 'fast', at block 512
  and 256);
- b12: ``vjp_pos_pair`` (B12, the grid backward) on the same bodies, a
  whole call over the 262,144^2 square with masses and with unit masses,
  and a ragged 3001 x 9001 call with masses (a tree with the pair-once
  B12: at its tile, else at block 512); in such a tree the whole call's
  slot_reduce launches alone, and the same call as B11's CROSS mode
  (``vjp_sym_sums_``, 'masked', zero column cotangents, tile 128), with
  its error on B12's scale; and the same function as two B10 launches,
  each side with the other side's cotangent zero (the two-sided design on
  B10's register body);
- reduce: slot_reduce alone on random partials: one piece of K3's cross
  list at N = 2^20's chunk 131,072 (tile 128, width 3), the same piece at
  K2's width 8, and the first piece of B13's tri list at N = 65,536 (tile
  128, width 8); the reduces of a whole 2^20 ``auto`` (K3) and
  ``sym_mxu`` (K2) pass (8 tri and 28 cross calls' pieces), each a list
  of readings; in a tree whose plans carry a launch order, each also with
  the identity order (turns: the plan's, identity, identity, the plan's);
  and digests of B9a and B9b (16 x 4096 plummer systems with masses);
- rollout: one warm 10-step "sqrt" rollout gradient at N = 262,144 (config
  3's physics: leapfrog, dt 1e-3) on ``auto`` (K3 and the tree's fp32
  backward, B11 on the card's route, loss on the final positions) and on
  ``sym_mxu`` (K2 and its bf16 backward, B13, loss on the final
  velocities), after a warm-up run;
- pvjp: the pair-once VJPs B11 and B13 on plummer bodies of N = 65,536
  with masses and a normal cotangent: one launch over the first piece of
  the tri slot list (PIECE_SLOTS slots, no slot_reduce) at tiles 64 and
  128, masked and maskless, with and without the mass cotangent; whole
  ``vjp_pos_sym`` / ``vjp_pos_sym_mxu`` calls at both tiles, 'fast' and
  'masked'; and the 16 x 65,536 ensemble backwards B9c and B9d
  (``vjp_pos_sym_ensemble`` / ``vjp_pos_sym_mxu_ensemble``) at both tiles;
- bwdmax: whole VJP calls at N = 65,536 to 1,048,576 (plummer, with
  masses and with unit masses, 'fast' and 'auto', which is what autodiff
  passes): B11 (``vjp_pos_sym``, chunked at 131,072) against B10
  (``vjp_pos_direct``, block 512) and B13 (``vjp_pos_sym_mxu``) against
  B14 (``vjp_rect_mxu``), the measurement behind autodiff's card route;
- direct: K1 through ``body_force_direct`` over one N = 2^20 pass at
  block (tile_i) 512, with unit masses and with masses; K5 at config 2
  (``simulate`` of N = 65,536 uniform bodies, 10 fused Euler steps, block
  512), ms per step; digests of K1 and of one K5 step on 50,001 bodies
  (a ragged edge) at blocks 128, 256 and 512, with and without masses, at
  softenings 1e-9 and 1e-13, and of K1 from one half of them onto the
  other at those and 1e-40 (the cube, normal and rsqrtf forms of a tree
  with ``direct_force.rsqrt_form``); in such a tree, the sweep of rows
  a thread R and rows a CTA that chose ``row_schedule`` (K1 at 2^20 with
  unit masses, K5 at config 2), each with its digest, registers and CTAs
  per SM;
- pe: K4 through ``potential_energy_kernel`` on config 3's plummer bodies
  (N = 262,144, softening 1e-2) with masses and with unit masses, and on
  3001 bodies with masses, with U and the digest of its row sums; digests
  of the row sums on the 50,001 bodies at blocks 128, 256 and 512, with
  and without masses, at softenings 1e-2 and 1e-40 (normal and rsqrtf); in
  a tree with the row schedule, its sweep of R and rows at 262,144 with
  masses;
- SHA-256 digests (first 16 hex digits) of each kernel's output bytes: K3's
  and K2's sums of the timed calls, B15's final state in both classes, B6's
  raw sums and forces at 262,144 in both classes, B16's rows and columns of
  one tri and one cross call, B14's rows, B10's and B12's outputs, B11's
  and B13's partial tiles, calls and ensemble backwards, the reduces'
  accumulators, B9a's and B9b's forces; equal digests mean equal bits;
- nvcc's ptxas report for those kernels (registers, spill bytes), and
  CTAs per SM: from the kernel's own occupancy query where the tree has one
  (``symmetric_force_info``, ``slot_pipe_info``, ``mxu_force_info``,
  ``band_mxu_info``, ``vjp_rect_mxu_info``, ``vjp_ordered_info``,
  ``vjp_sym_info``, ``vjp_mxu_info``), else
  computed from the registers, threads and shared memory of the body (H100:
  65,536 registers, 2048 threads, 32 CTAs and 233,472 bytes of shared
  memory per SM);
- the SASS of B10, B14, B11, B13, B12, K1, K5 and K4 (``cuobjdump -sass``
  of the tree's library): for each loop holding a rsqrt (``MUFU.RSQ``), its
  instructions, rsqrts and the instructions of rsqrtf's denormal
  rescaling (those with the 2^24 scale, 16777216), so instructions per
  pair of the innermost pair loop; and for each straight run of code (no
  label, no branch) holding 8 rsqrts or more, its instructions from the
  first rsqrt to the last and its rsqrts, so instructions per pair of a
  pass unrolled over its pairs (B11's and B12's micro-tiles, B13's steps).
  With direct or pe and ``--sass-dir DIR``, the SASS text of K1, K5 and
  K4 goes to ``DIR/ab_sass_<tree's directory name>.txt``.
The parent prints the same lines, so the two trees are compared within one
call on one card. The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

N, CHUNK, TILE, SEED = 1 << 20, 131072, 128, 0
N_CONFIG1, STEPS_CONFIG1, DT_CONFIG1 = 4096, 10, 0.01
N_CONFIG3, SOFT_CONFIG3 = 262144, 1e-2
ROLLOUT_STEPS, ROLLOUT_DT = 10, 1e-3
REPS = 5
SECTIONS = ("slots", "band", "passes", "b15", "b6", "vjp", "rollout", "pvjp",
            "bwdmax", "b12", "reduce", "direct", "pe")
#: b15: the larger N of its fp32 step and that call's steps; the N of its
#: fixed-cost runs, their steps (fewer, more), the profiled calls and the
#: CPU operators shown.
B15_BIG_N, B15_BIG_STEPS = 16384, 20
B15_SMALL_N, B15_SHORT, B15_PROFILED, B15_TOP_OPS = 512, (2, 20), 20, 8
#: b12: the ragged call's sets; reduce: the ensemble (B, N) of B9a and B9b.
B12_RAGGED = (3001, 9001)
ENS_REDUCE = (16, 4096)
#: pvjp: N of the launches and calls, the ensemble (B, N); bwdmax: the Ns.
N_PVJP, ENS_PVJP = 65536, (16, 65536)
BWDMAX_NS = (65536, 131072, 262144, 524288, 1048576)
#: direct and pe: K1's block at 2^20, config 2 (N, fused Euler steps), the
#: digests' N (a ragged edge at every block), blocks and softenings (K1 and
#: K5: the cube, normal and rsqrtf forms; K4: normal and rsqrtf), K4's
#: ragged N; the sweep's rows a thread and rows a CTA.
DIRECT_BLOCK = 512
N_CONFIG2, STEPS_CONFIG2 = 65536, 10
N_DIGEST, DIGEST_BLOCKS = 50001, (128, 256, 512)
DIRECT_SOFTENINGS, PE_SOFTENINGS = (1e-9, 1e-13, 1e-40), (1e-2, 1e-40)
N_PE_RAGGED = 3001
SWEEP_R, SWEEP_ROWS = (1, 2, 4), (128, 256, 512, 1024)
#: Threads and dynamic shared memory per CTA of the bodies before their
#: register designs, for trees without an occupancy query: K3 2T threads and
#: a T x T w tile, (T (T + 1) + 8 T) floats; K2 256 threads, the bf16 W tile
#: of T (T + 8), v_a, v_b and the positions; B6 256 threads, its bf16 W
#: tile, v, a fragment scratch and the positions (48,640 bytes); B16 256
#: threads, its bf16 W tile, v_i, v_j and the positions (41,984 bytes); B14
#: 256 threads, its bf16 W and C tiles, Qg, Qp, the warps' products and the
#: k and j blocks (89,088 bytes at tile 128); B10 one thread per receiver at
#: block 512, two float4s per staged source (16,384 bytes); B11 2T threads,
#: its fp32 W and C tiles (rows padded to T + 1) and the blocks (36,864
#: bytes at tile 64); B13 256 threads, its bf16 W and C tiles for both fold
#: sides, Qg, Qp, the warps' products, the blocks and the mass partials
#: (177,152 bytes at tile 128); B12's two sides as B10's old body; K1 and
#: K5 one thread a row at block 512, K4 at its block 256 (a float4 per
#: staged source).
SHARED_W_BODIES = {"K3": (256, 70144), "K2": (256, 76800),
                   "B6": (256, 48640), "B16": (256, 41984),
                   "B14": (256, 89088), "B10": (512, 16384),
                   "B11": (128, 36864), "B13": (256, 177152),
                   "B12": (512, 16384), "K1": (512, 8192),
                   "K5": (512, 8192), "K4": (256, 4096)}
#: The timed instantiations: K3 at tile 128, unit masses, fast rsqrt; K2 and
#: B16 at tile 128 without split_w (B16 with fast rsqrt); B6's bf16 class
#: with masses; B14 at tile 128 and B10 at block 512, with masses. Parts of
#: the mangled names, this tree's and the parent's; B11 at tile 64 and B13
#: at tile 128 with masses, no mass cotangent (the parent's default tiles);
#: K1 (2^20) and K5 (config 2) with unit masses and the cube form at the
#: rows a thread row_schedule gives them, K4 with the normal form.
SLOT_KERNELS = {"K3": ("symmetric_force_kernelILi128ELi3ELb1E",),
                "K2": ("slot_pipe_kernelILi128ELb0E",),
                "B6": ("mxu_bf16_kernelILb1E",
                       "mxu_force_kernelILb1ELb1E"),
                "B16": ("band_mxu_kernelILi128ELb0ELb1E",
                        "band_mxu_kernelILi128ELb0E"),
                "B14": ("vjp_rect_mxu_kernelILi128ELi4E",),
                "B10": ("vjp_ordered_kernelILi4ELb1E",
                        "vjp_ordered_kernelILb1ELi0E"),
                "B11": ("vjp_sym_kernelILi64ELi4ELi3E",),
                "B13": ("vjp_mxu_kernelILi128ELi4ELi8E",),
                "B12": ("vjp_pair_kernelILi128ELi4E",
                        "vjp_side_kernelILb1ELi1E"),
                "K1": ("direct_force_kernelILi4ELb0ELi2ELb0E",
                       "direct_force_kernelILb0ELb1ELb0E"),
                "K5": ("direct_force_kernelILi1ELb0ELi2ELb1E",
                       "direct_force_kernelILb0ELb1ELb1E"),
                "K4": ("pe_rows_kernelILi2ELb1E", "pe_rows_kernelILb1E")}
#: B12's kernels whose SASS is counted: this tree's with masses, the
#: parent's two sides with masses.
B12_SASS = ("vjp_pair_kernelILi128ELi4E", "vjp_side_kernelILb1ELi")


def find_kernel(report, names):
    """The ptxas report entry of the first of ``names`` (parts of mangled
    names, in order of preference) that some kernel of ``report`` contains,
    or {}. This tree's name comes first: the parent's B16 name is a prefix
    of every instantiation of this tree's."""
    return next((v for m in names for k, v in report.items() if m in k), {})


def digest(*tensors):
    """First 16 hex digits of the SHA-256 of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ctas_per_sm(regs, threads, smem):
    """CTAs per SM of an H100 from a kernel's registers, threads and dynamic
    shared memory (registers allocated per warp in units of 256)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def loop_bodies(sass):
    """[instructions] of each loop of one function's SASS (``cuobjdump
    -sass`` text) that holds a ``MUFU.RSQ``: a loop runs from a backward
    branch's target to the branch."""
    addr, ops, labels, branches = [], [], {}, []
    pending = []
    for ln in sass.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if not m:
            continue
        a, op = int(m.group(1), 16), m.group(2)
        for lab in pending:
            labels[lab] = a
        pending = []
        addr.append(a)
        ops.append(op)
        b = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", op)
        if b:
            branches.append((a, b.group(1) or int(b.group(2), 16)))
    loops = []
    for a, target in branches:
        t = labels.get(target) if isinstance(target, str) else target
        if t is None or t > a:
            continue
        body = [op for x, op in zip(addr, ops) if t <= x <= a]
        if any("MUFU.RSQ" in op for op in body):
            loops.append(body)
    return loops


def sass_loops(sass):
    """[(instructions, rsqrts)] of each loop of loop_bodies."""
    return [(len(b), sum("MUFU.RSQ" in op for op in b))
            for b in loop_bodies(sass)]


def sass_rescales(sass):
    """For each loop of loop_bodies, its instructions of rsqrtf's denormal
    rescaling: those holding its 2^24 input scale (16777216)."""
    return [sum(bool(re.search(r"\b16777216\b", op)) for op in b)
            for b in loop_bodies(sass)]


def sass_runs(sass, least=8):
    """[(instructions, rsqrts)] of each straight run of one function's SASS
    (no label inside, no branch or barrier) that holds at least ``least``
    rsqrts: the instructions from its first ``MUFU.RSQ`` to its last, and
    the rsqrts, so (instructions - 1) / (rsqrts - 1) per pair where a pass
    is unrolled over its pairs."""
    runs, ops = [], []

    def close():
        idx = [i for i, op in enumerate(ops) if "MUFU.RSQ" in op]
        if len(idx) >= least:
            runs.append((idx[-1] - idx[0] + 1, len(idx)))
        ops.clear()

    for ln in sass.splitlines():
        if re.match(r"\s*\.L_x_\d+:", ln):
            close()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", ln)
        if not m:
            continue
        ops.append(m.group(1))
        if re.search(r"\b(BRA|EXIT|RET|BAR)\b", m.group(1)):
            close()
    close()
    return runs


def kernel_sass(lib_path, names, dump=(), dump_to=None):
    """{mangled name: its sass_loops, sass_runs and sass_rescales} of the
    kernels of the library whose mangled names contain one of ``names``;
    the SASS text of those containing one of ``dump`` goes to the file
    ``dump_to``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=600).stdout
    out, dumped = {}, []
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split(None, 1)[0]
        if any(n in name for n in names):
            out[name] = {"loops": sass_loops(part), "runs": sass_runs(part),
                         "rescales": sass_rescales(part)}
        if any(n in name for n in dump):
            dumped.append(f"Function : {part}")
    if dump_to is not None and dumped:
        os.makedirs(os.path.dirname(dump_to), exist_ok=True)
        with open(dump_to, "w") as f:
            f.write("\n".join(dumped))
    return out


def b15_extra(dev, gen, rs, simulate, SimConfig, init, time_fn, digest):
    """The b15 section beyond config 1: a step at B15_BIG_N in both
    classes (ms per step of a B15_BIG_STEPS-step call, and its digest);
    the fixed cost of a resident Euler ``simulate`` call at B15_SMALL_N in
    both classes (median host ms of calls of B15_SHORT steps, so ms per
    step and the fixed part by their difference); and where that fixed part goes: torch.profiler
    over B15_PROFILED calls of the shorter one, the CPU operators' self
    time per call and the kernel's device time per call."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    s = init.uniform_random(B15_BIG_N, generator=gen, device=dev)

    def big(mxu):
        return rs.simulate_resident_sym(s.pos, s.vel, None,
                                        steps=B15_BIG_STEPS, dt=1e-4,
                                        mxu=mxu)

    out["big_n"] = B15_BIG_N
    for mxu in (False, True):
        cls = "bf16" if mxu else "fp32"
        out[f"big_ms_per_step_{cls}"] = time_fn(big, mxu,
                                                reps=REPS) * 1e3 / (
            B15_BIG_STEPS)
        out[f"big_digest_{cls}"] = digest(*big(mxu))
    small = init.uniform_random(B15_SMALL_N, generator=gen, device=dev)
    for backend in ("sym", "sym_mxu"):
        calls = {k: (lambda k=k: simulate(SimConfig(
            n=B15_SMALL_N, steps=k, dt=1e-4, backend=backend,
            resident=True), small)) for k in B15_SHORT}
        ms = {}
        for k, fn in calls.items():
            fn()
            times = []
            for _ in range(4 * REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            ms[k] = float(np.median(times)) * 1e3
        lo, hi = B15_SHORT
        step = (ms[hi] - ms[lo]) / (hi - lo)
        rec = {"ms_per_call": {str(k): v for k, v in ms.items()},
               "ms_per_step": step, "fixed_ms": ms[lo] - lo * step}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(B15_PROFILED):
                calls[lo]()
            torch.cuda.synchronize()
        cpu, device_us = {}, 0.0
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            if "resident" in e.key and dev_us > 0:
                device_us += dev_us / B15_PROFILED
            elif e.self_cpu_time_total > 0:
                cpu[e.key] = e.self_cpu_time_total / B15_PROFILED
        rec["kernel_device_us_per_call"] = device_us
        rec["cpu_self_us_per_call"] = dict(sorted(
            cpu.items(), key=lambda kv: -kv[1])[:B15_TOP_OPS])
        out[f"n{B15_SMALL_N}_{backend}"] = rec
    return out


def worker(tree, only, sass_dir=None):
    sys.path.insert(0, os.path.abspath(tree))
    import ctypes

    import numpy as np
    import torch

    from mini_nbody_tpu_torch import BodyState, SimConfig, _build, init
    from mini_nbody_tpu_torch import simulate
    from mini_nbody_tpu_torch.ops import direct_force as df
    from mini_nbody_tpu_torch.ops import mxu_force as mf
    from mini_nbody_tpu_torch.ops import pe_kernel as pk
    from mini_nbody_tpu_torch.ops import resident_sym as rs
    from mini_nbody_tpu_torch.ops import slot_pipe as sp
    from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
    from mini_nbody_tpu_torch.ops import symmetric_force as sf
    from mini_nbody_tpu_torch.ops import vjp_kernel as vk
    from mini_nbody_tpu_torch.ops import vjp_mxu as vm
    from mini_nbody_tpu_torch.ops.force import make_force_fn
    from mini_nbody_tpu_torch.sim import init_carry, make_rollout_fn
    from mini_nbody_tpu_torch.utils.config import SOFTENING, fast_rsqrt_cube
    from mini_nbody_tpu_torch.utils.harness import time_fn

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.load_library()
    build_s = time.perf_counter() - t0
    stream = torch.cuda.current_stream(dev).cuda_stream
    soft, fast = SOFTENING, int(fast_rsqrt_cube(SOFTENING))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = init.uniform_random(N, generator=gen, device=dev)
    tile, c, _, np_ = sm._resolve_tiling(N, TILE, CHUNK, kernel=True)
    nb = c // tile
    slots = {"tri": sp.slot_table(nb, True, False, dev),
             "cross": sp.slot_table(nb, False, True, dev)}
    piece = sp.PIECE_SLOTS
    rec = {"tree": tree, "build_s": build_s, "n": N, "chunk": c,
           "tile": tile, "sections": list(only), "kernels": {}}

    def launches_only(launch, table, width):
        """One call's kernel launches, one per piece, into one scratch."""
        part = torch.empty(piece * 2 * tile * width, device=dev)
        s = table.shape[0]

        def run():
            for s0 in range(0, s, piece):
                _build.check(lib, launch(table[s0:], min(piece, s - s0),
                                         part), "launch")

        return run, -(-s // piece)

    # K3 (unit masses).
    p = sf._pack(state.pos, None, N, np_)
    for mode, table in slots.items() if "slots" in only else ():
        b = p[c:2 * c] if mode == "cross" else p[:c]
        run, per = launches_only(
            lambda t, n, part, b=b: lib.symmetric_force_launch(
                t.data_ptr(), n, 1, 0, p.data_ptr(), b.data_ptr(),
                part.data_ptr(), 3, tile, soft, fast, stream), table, 3)
        ms = time_fn(run, reps=REPS) * 1e3 / per
        got = [torch.zeros((c, 3), device=dev) for _ in range(2)]
        want = [torch.zeros((c, 3), device=dev) for _ in range(2)]
        acc = (got if mode == "cross" else [got[0]] * 2)
        ref = (want if mode == "cross" else [want[0]] * 2)
        sf.symmetric_sums_(acc[0], acc[1], p[:c], b, table, tile, soft)
        sf.symmetric_sums_plain(ref[0], ref[1], p[:c], b, table, tile, soft)
        err = max(((g - w).abs().max() / w.abs().max().clamp_min(1.0)).item()
                  for g, w in zip(got, want))
        rec["kernels"][f"K3 {mode}"] = {"ms_per_launch": ms,
                                        "launches_per_call": per,
                                        "err_of_scale": err,
                                        "digest": digest(*got)}

    # K2 (unit masses, maskless, no split).
    p, v = sm._pack(state.pos, None, N, np_)
    for mode, table in slots.items() if "slots" in only else ():
        b, vb = ((p[c:2 * c], v[c:2 * c]) if mode == "cross"
                 else (p[:c], v[:c]))
        ms = {}
        for mask in (0, 1):
            run, per = launches_only(
                lambda t, n, part, b=b, vb=vb, mask=mask: lib.slot_pipe_launch(
                    t.data_ptr(), n, 1, 0, p.data_ptr(), b.data_ptr(),
                    v.data_ptr(), vb.data_ptr(), part.data_ptr(), tile, soft,
                    fast, 0, mask, stream), table, 8)
            ms[mask] = time_fn(run, reps=REPS) * 1e3 / per
        if mode == "cross":
            got = sp.build_cross_slot_call(soft, tile, c, mask=False)(
                p[:c], b, v[:c], vb)
            want = sp.cross_slot_sums_plain(p[:c], b, v[:c], vb, soft, tile,
                                            mask=False,
                                            mma_dtype=torch.bfloat16)
        else:
            got = (sp.build_tri_slot_call(soft, tile, c,
                                          mask_offdiag=False)(p[:c], v[:c]),)
            want = (sp.tri_slot_sums_plain(p[:c], v[:c], soft, tile,
                                           mask_offdiag=False,
                                           mma_dtype=torch.bfloat16),)
        err = max(((g - w).abs().amax(dim=1) / w.abs().amax(dim=1)
                   .clamp_min(1e-30)).max().item()
                  for g, w in zip(got, want))
        rec["kernels"][f"K2 {mode}"] = {"ms_per_launch": ms[0],
                                        "ms_per_launch_masked": ms[1],
                                        "launches_per_call": per,
                                        "err_of_scale": err,
                                        "digest": digest(*got)}

    # B16 (unit masses, no split): one launch over every row block, no
    # slot_reduce; the digest of one call through the public entry. The tri
    # launch also over the first k SMs' worth of row blocks, k = 1, 2, ...:
    # what a partial last wave of CTAs costs.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for mode in slots if "band" in only else ():
        cross = mode == "cross"
        b, vb = ((p[c:2 * c], v[c:2 * c]) if cross else (p[:c], v[:c]))
        _, _, longest = sm.band_launches(nb, cross)
        part = torch.empty(longest * tile * 8, device=dev)
        rows = torch.zeros((c, 8), device=dev)

        def band(mask, n_rows=nb, b=b, vb=vb, cross=cross, part=part,
                 rows=rows):
            _build.check(lib, lib.band_mxu_launch(
                p.data_ptr(), b.data_ptr(), v.data_ptr(), vb.data_ptr(),
                rows.data_ptr(), part.data_ptr(), nb, 0, n_rows, int(cross),
                1, c, tile, soft, fast, 0, mask, stream), "band_mxu_launch")

        ms = {mask: time_fn(band, mask, reps=REPS) * 1e3 for mask in (0, 1)}
        if not cross:
            rec["b16_tri_ms_by_row_blocks"] = {
                n: time_fn(band, 0, n, reps=REPS) * 1e3
                for n in [*range(sms, nb, sms), nb]}
        rows = torch.zeros((c, 8), device=dev)
        cols = torch.zeros((c, 8), device=dev)
        if cross:
            sm.band_cross_sums_(rows, cols, p[:c], b, v[:c], vb, tile, soft)
        else:
            sm.band_tri_sums_(rows, cols, p[:c], v[:c], tile, soft)
        rec["kernels"][f"B16 {mode}"] = {"ms_per_launch": ms[0],
                                         "ms_per_launch_masked": ms[1],
                                         "digest": digest(rows, cols)}

    for name, cfg in () if "passes" not in only else (
            ("auto", SimConfig(n=N, backend="auto", sym_chunk=CHUNK)),
            ("sym_mxu", SimConfig(n=N, backend="sym_mxu", sym_chunk=CHUNK)),
            ("mxu_bf16", SimConfig(n=N, backend="mxu",
                                   pair_dtype="bfloat16")),
            ("band", SimConfig(n=N, backend="sym_mxu", traversal="band",
                               sym_chunk=CHUNK))):
        f = make_force_fn(cfg)
        rec[f"pass_ms_{name}"] = time_fn(f, state.pos, state.pos,
                                         reps=3) * 1e3
    s1 = init.uniform_random(N_CONFIG1, generator=gen, device=dev)
    for mxu in (False, True) if "b15" in only else ():
        cls = "bf16" if mxu else "fp32"
        for name, fn in (("", rs.simulate_resident_sym),
                         ("_leapfrog", rs.simulate_resident_sym_leapfrog),
                         ("_yoshida4", rs.simulate_resident_sym_yoshida4)):
            run = (lambda fn=fn, mxu=mxu: fn(
                s1.pos, s1.vel, None, steps=STEPS_CONFIG1, dt=DT_CONFIG1,
                mxu=mxu))
            rec[f"b15_config1{name}_ms_{cls}"] = time_fn(run,
                                                         reps=REPS) * 1e3
            rec[f"b15_config1{name}_digest_{cls}"] = digest(*run())
    if "b15" in only:
        rec["b15"] = b15_extra(dev, gen, rs, simulate, SimConfig, init,
                               time_fn, digest)

    # B6 at config 3's N on the route 'auto' takes (the overlap run when
    # the scan finds no duplicate), bf16 class timed, both classes digested.
    s3 = init.plummer(N_CONFIG3, generator=torch.Generator(
        device=dev).manual_seed(SEED + 2), device=dev)
    if "b6" in only:
        overlap = mf.square_overlap_only(s3.pos, "auto")
        b6 = {"n": N_CONFIG3, "overlap": overlap}
        b6["ms_per_launch"] = time_fn(
            mf.hybrid_forces, s3.pos, s3.pos, s3.mass, SOFT_CONFIG3, 512,
            2048, overlap, reps=REPS) * 1e3
        for dtype in ("bfloat16", "float32"):
            b6[f"digest_{dtype}"] = digest(*mf.hybrid_forces(
                s3.pos, s3.pos, s3.mass, SOFT_CONFIG3, overlap_only=overlap,
                pair_dtype=dtype, with_sums=True))
        rec["kernels"]["B6"] = b6

    # B14, B10 and B12 on config 3's bodies with a normal cotangent.
    g3 = torch.randn((N_CONFIG3, 3), generator=torch.Generator(
        device=dev).manual_seed(SEED + 3), device=dev)
    pm = (s3.pos, g3, s3.pos, g3, s3.mass, s3.mass, SOFT_CONFIG3)
    for mode, masses in (("fast", True), ("masked", True), ("fast", False)) \
            if "vjp" in only else ():
        args = (*(pm if masses else (*pm[:4], None, None, pm[6])), 128, mode)
        key = f"B14 {mode}" + ("" if masses else " unit masses")
        rec["kernels"][key] = {
            "n": N_CONFIG3, "tile": 128,
            "ms_per_launch": time_fn(vm.vjp_rect_mxu_rows, *args,
                                     reps=REPS) * 1e3,
            "digest": digest(vm.vjp_rect_mxu_rows(*args))}
    for block in (512, 256) if "vjp" in only else ():
        args = (s3.pos, g3, s3.mass, SOFT_CONFIG3, block, "fast")
        rec["kernels"][f"B10 block {block}"] = {
            "n": N_CONFIG3, "block": block,
            "ms_per_launch": time_fn(vk.vjp_pos_direct, *args,
                                     reps=REPS) * 1e3,
            "digest": digest(vk.vjp_pos_direct(*args))}

    # B12 on the same bodies: this tree's (or the parent's, at block 512),
    # its reduces alone, B11's cross mode with zero column cotangents, and
    # the two-sided design on B10's body.
    if "b12" in only:
        new_b12 = hasattr(vk, "PAIR_TILE")
        sizes = {"tile ": (vk.PAIR_TILE,)} if new_b12 else {"": (512,)}
        ra, rb = B12_RAGGED
        gr = torch.Generator(device=dev).manual_seed(SEED + 12)
        pr = torch.rand((ra + rb, 3), generator=gr, device=dev) * 2 - 1
        mr = torch.rand(ra + rb, generator=gr, device=dev) + 0.5
        cases = (("", s3.pos, g3, s3.pos, s3.mass),
                 (" unit masses", s3.pos, g3, s3.pos, None),
                 (f" ragged {ra}x{rb}", pr[:ra], g3[:ra], pr[ra:], mr[ra:]))
        for (what, size), (case, pa, ga, pb, mb) in (
                ((w, z), c) for w, zs in sizes.items() for z in zs
                for c in cases):
            kw = {} if new_b12 else {"block": size}
            args = (pa, ga, pb, None, mb, SOFT_CONFIG3)
            rec["kernels"][f"B12 {what}{size}{case}"] = {
                "na": pa.shape[0], "nb": pb.shape[0],
                "ms_per_call": time_fn(lambda: vk.vjp_pos_pair(*args, **kw),
                                       reps=3) * 1e3,
                "digest": digest(*vk.vjp_pos_pair(*args, **kw))}
        if new_b12:
            t = vk.PAIR_TILE
            np_ = -(-N_CONFIG3 // t) * t
            table = sp.slot_table(np_ // t, False, True, dev)
            acc = torch.zeros((np_, 3), device=dev)
            rec["b12_reduce_ms"] = time_fn(
                sp.run_slot_pieces, "none", table, False, t, 3, acc,
                torch.zeros_like(acc), lambda *a: 0, lambda: None,
                reps=3) * 1e3
            from mini_nbody_tpu_torch.ops.symmetric_force import _pack

            def b11_as_b12(m):
                # the 262,144^2 square as B11's CROSS mode, 'masked', g_b = 0
                pk = _pack(s3.pos, m, N_CONFIG3, np_)
                gk = vk._pad_rows(g3, np_)
                acc_a = torch.zeros((np_, 3), device=dev)
                acc_b = torch.zeros((np_, 3), device=dev)
                vk.vjp_sym_sums_(acc_a, acc_b, pk, pk, gk,
                                 torch.zeros_like(gk), table, t,
                                 SOFT_CONFIG3, mask_offdiag=True)
                return acc_a[:N_CONFIG3], acc_b[:N_CONFIG3]

            for case, m in (("", s3.mass), (" unit masses", None)):
                got = b11_as_b12(m)
                want = vk.vjp_pos_pair(s3.pos, g3, s3.pos, None, m,
                                       SOFT_CONFIG3)
                rec["kernels"][f"B12 as B11 cross tile {t}{case}"] = {
                    "ms_per_call": time_fn(b11_as_b12, m, reps=3) * 1e3,
                    "digest": digest(*got),
                    "max_err_of_b12_scale": max(
                        ((x - y).abs().max() / y.abs().max()).item()
                        for x, y in zip(got, want))}
        one = torch.ones_like(s3.mass)

        def two_b10():
            zero = torch.zeros_like(g3)
            return (vk.vjp_pos_rect(s3.pos, g3, s3.pos, zero, one, s3.mass,
                                    SOFT_CONFIG3, 512),
                    vk.vjp_pos_rect(s3.pos, zero, s3.pos, g3, s3.mass, one,
                                    SOFT_CONFIG3, 512))

        rec["kernels"]["B12 as two B10 launches"] = {
            "ms_per_call": time_fn(two_b10, reps=3) * 1e3,
            "digest": digest(*two_b10())}

    # slot_reduce alone on random partials (the same on both trees: one
    # generator seed), and the ensemble forces behind it.
    # A tree whose plans carry a launch order (longest list first) also
    # runs every reduce with the identity order, the variants in turns
    # (order, identity, identity, order).
    if "reduce" in only:
        _, c65, _, _ = sm._resolve_tiling(N_PVJP, TILE, CHUNK, kernel=True)
        cases = (("K3 cross piece", slots["cross"], False, 3, c),
                 ("K2 cross piece", slots["cross"], False, 8, c),
                 ("B13 tri piece", sp.slot_table(c65 // TILE, True, False,
                                                 dev), True, 8, c65))
        ordered = hasattr(sp, "launch_order")
        longest_first = getattr(sp, "launch_order", None)
        variants = (("", " identity order", " identity order", "")
                    if ordered else ("",))
        for turn, suffix in enumerate(variants):
            if ordered:
                sp.launch_order = (longest_first if not suffix else
                                   lambda off: np.arange(len(off) - 1))
                sp._PLANS.clear()
            gr = torch.Generator(device=dev).manual_seed(SEED + 13)
            for name, table, tri, width, rows in cases:
                plan = sp.reduce_plan(table, tri)[0]
                part = torch.randn(plan[1] * 2 * TILE * width, generator=gr,
                                   device=dev)
                acc = [torch.zeros((rows, width), device=dev)
                       for _ in range(2)]
                accs = (acc[0], acc[0] if tri else acc[1])
                ms = time_fn(sp.slot_reduce_, part, plan, *accs, TILE, width,
                             reps=REPS) * 1e3
                acc = [torch.zeros((rows, width), device=dev)
                       for _ in range(2)]
                accs = (acc[0], acc[0] if tri else acc[1])
                sp.slot_reduce_(part, plan, *accs, TILE, width)
                rec["kernels"].setdefault(f"reduce {name}{suffix}", {
                    "width": width, "slots": plan[1],
                    "targets": plan[2].shape[0], "ms_per_launch": [],
                    "digest": digest(*acc)})["ms_per_launch"].append(ms)
            for name, width in (("auto", 3), ("sym_mxu", 8)):
                acc = torch.zeros((c, width), device=dev)
                ms = {mode: time_fn(sp.run_slot_pieces, "none", table,
                                    mode == "tri", TILE, width, acc,
                                    acc if mode == "tri" else acc.clone(),
                                    lambda *a: 0, lambda: None, reps=3) * 1e3
                      for mode, table in slots.items()}
                nc = N // c
                rec.setdefault(f"pass_reduce_ms_{name}{suffix}", []).append(
                    nc * ms["tri"] + nc * (nc - 1) // 2 * ms["cross"])
        if ordered:
            sp.launch_order = longest_first
            sp._PLANS.clear()
        b, n = ENS_REDUCE
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        systems = [init.plummer(n, generator=gen, device=dev)
                   for _ in range(b)]
        pos_e = torch.stack([x.pos for x in systems])
        mass_e = torch.stack([x.mass for x in systems])
        rec["kernels"]["B9a"] = {"b": b, "n": n, "digest": digest(
            sm.body_force_sym_mxu_ensemble(pos_e, mass_e,
                                           traversal="slots"))}
        rec["kernels"]["B9b"] = {"b": b, "n": n, "digest": digest(
            sf.body_force_symmetric_ensemble(pos_e, mass_e))}

    # The rollout gradient at config 3's N, warm (time_fn's warm-up run).
    for backend, on in (("auto", "pos"), ("sym_mxu", "vel")) \
            if "rollout" in only else ():
        cfg = SimConfig(n=N_CONFIG3, dt=ROLLOUT_DT, softening=SOFT_CONFIG3,
                        integrator="leapfrog", use_masses=True,
                        backend=backend)
        state0, acc0 = init_carry(cfg, s3)
        rollout = make_rollout_fn(cfg, ROLLOUT_STEPS, "sqrt")

        def grad(rollout=rollout, on=on, state0=state0, acc0=acc0):
            pos = state0.pos.clone().requires_grad_(True)
            out, _ = rollout((BodyState(pos=pos, vel=state0.vel,
                                         mass=state0.mass), acc0))
            (((out.pos if on == "pos" else out.vel) ** 2).sum()).backward()
            return pos.grad

        rec[f"rollout_grad_s_{backend}"] = time_fn(grad, reps=2)
        rec[f"rollout_grad_digest_{backend}"] = digest(grad())
        rec[f"rollout_grad_loss_on_{backend}"] = on

    # B11 and B13 (pvjp) and the card's routing (bwdmax) on plummer bodies
    # and a normal cotangent.
    def plummer_case(n, seed):
        st = init.plummer(n, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev)
        g = torch.randn((n, 3), generator=torch.Generator(
            device=dev).manual_seed(seed + 1), device=dev)
        return st, g

    if "pvjp" in only:
        sv, gv = plummer_case(N_PVJP, SEED + 4)
        for name, mod, kos in (("B11", vk, (3, 4)), ("B13", vm, (8, 9))):
            for tile in (64, 128):
                if name == "B13":
                    (_, c, _, np_), (pp, gg, qq) = vm.sums_inputs(
                        sv.pos, gv, sv.mass, tile, CHUNK)
                else:
                    _, c, _, np_ = sm._resolve_tiling(N_PVJP, tile, CHUNK,
                                                      kernel=True)
                    pp = sf._pack(sv.pos, sv.mass, N_PVJP, np_)
                    gg = vk._pad_rows(gv, np_)
                table = sp.slot_table(c // tile, True, False, dev)
                n = min(piece, table.shape[0])
                for ko in kos:
                    part = torch.empty(n * 2 * tile * ko, device=dev)
                    for mask in (0, 1):
                        def launch(name=name, tile=tile, ko=ko, mask=mask,
                                   part=part, pp=pp, gg=gg, table=table,
                                   n=n):
                            if name == "B13":
                                code = lib.vjp_mxu_launch(
                                    table.data_ptr(), n, 1, 0, pp.data_ptr(),
                                    pp.data_ptr(), gg.data_ptr(),
                                    gg.data_ptr(), qq.data_ptr(),
                                    qq.data_ptr(), part.data_ptr(), 1, ko,
                                    tile, SOFT_CONFIG3, mask, stream)
                            else:
                                code = lib.vjp_sym_launch(
                                    table.data_ptr(), n, 1, 0, pp.data_ptr(),
                                    pp.data_ptr(), gg.data_ptr(),
                                    gg.data_ptr(), part.data_ptr(), 4, ko,
                                    tile, SOFT_CONFIG3, mask, stream)
                            _build.check(lib, code, name)

                        ms = time_fn(launch, reps=REPS) * 1e3
                        launch()
                        kind = "masked" if mask else "maskless"
                        rec["kernels"][
                            f"{name} launch tile {tile} ko {ko} {kind}"] = {
                                "n": N_PVJP, "slots": n, "ms_per_launch": ms,
                                "digest": digest(part)}
                fn = vm.vjp_pos_sym_mxu if name == "B13" else vk.vjp_pos_sym
                for mode in ("fast", "masked"):
                    args = (sv.pos, gv, sv.mass, SOFT_CONFIG3, tile, CHUNK,
                            False, mode)
                    rec["kernels"][f"{name} call tile {tile} {mode}"] = {
                        "n": N_PVJP,
                        "ms_per_call": time_fn(fn, *args, reps=3) * 1e3,
                        "digest": digest(fn(*args))}
        b, n = ENS_PVJP
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        systems = [init.plummer(n, generator=gen, device=dev)
                   for _ in range(b)]
        pos_e = torch.stack([x.pos for x in systems])
        mass_e = torch.stack([x.mass for x in systems])
        g_e = torch.randn((b, n, 3), generator=gen, device=dev)
        for name, fn in (("B9c", vk.vjp_pos_sym_ensemble),
                         ("B9d", vm.vjp_pos_sym_mxu_ensemble)):
            for tile in (64, 128):
                args = (pos_e, g_e, mass_e, SOFT_CONFIG3, tile)
                rec["kernels"][f"{name} backward tile {tile}"] = {
                    "b": b, "n": n,
                    "ms_per_call": time_fn(fn, *args, reps=3) * 1e3,
                    "digest": digest(fn(*args))}
    for n in BWDMAX_NS if "bwdmax" in only else ():
        sv, gv = plummer_case(n, SEED + 8)
        for masses, m in (("masses", sv.mass), ("unit", None)):
            for mode in ("fast", "auto"):
                for name, fn, args in (
                        ("B11", vk.vjp_pos_sym, (sv.pos, gv, m, SOFT_CONFIG3,
                                                 None, CHUNK, False, mode)),
                        ("B10", vk.vjp_pos_direct, (sv.pos, gv, m,
                                                    SOFT_CONFIG3, 512, mode)),
                        ("B13", vm.vjp_pos_sym_mxu, (sv.pos, gv, m,
                                                     SOFT_CONFIG3, None,
                                                     CHUNK, False, mode)),
                        ("B14", vm.vjp_rect_mxu, (sv.pos, gv, sv.pos, gv, m,
                                                  m, SOFT_CONFIG3,
                                                  vm.RECT_TILE, mode))):
                    rec.setdefault("bwdmax_ms", {}).setdefault(
                        f"{name} {masses} {mode}", {})[n] = \
                        time_fn(fn, *args, reps=3) * 1e3

    # K1 and K5 (direct), K4 (pe): each tree through its public wrappers,
    # so the parent's kernels run as they did; in a tree with the row
    # schedule, also the sweep of R and rows that chose it.
    sched = hasattr(df, "row_schedule")
    dgen = torch.Generator(device=dev).manual_seed(SEED + 15)
    pd = torch.rand((N_DIGEST, 3), generator=dgen, device=dev) * 2 - 1
    vd = torch.rand((N_DIGEST, 3), generator=dgen, device=dev) * 2 - 1
    md = torch.rand(N_DIGEST, generator=dgen, device=dev) + 0.5

    def info(fn, *args):
        out = (ctypes.c_int * 4)()
        _build.check(lib, getattr(lib, fn)(*args, ctypes.addressof(out)), fn)
        return {"registers": out[0], "local_bytes": out[1],
                "ctas_per_sm": out[2], "threads": out[3], "from": fn}

    if "direct" in only:
        m1 = torch.rand(N, generator=dgen, device=dev) + 0.5
        for case, m in (("unit masses", None), ("masses", m1)):
            args = (state.pos, state.pos, m, soft, DIRECT_BLOCK)
            rec["kernels"][f"K1 pass {case}"] = {
                "n": N, "block": DIRECT_BLOCK,
                "schedule": df.row_schedule(N, DIRECT_BLOCK) if sched
                else None,
                "ms_per_launch": time_fn(df.body_force_direct, *args,
                                         reps=3) * 1e3,
                "digest": digest(df.body_force_direct(*args))}
        s2 = init.uniform_random(N_CONFIG2, generator=torch.Generator(
            device=dev).manual_seed(SEED + 3), device=dev)
        cfg2 = SimConfig(n=N_CONFIG2, steps=STEPS_CONFIG2, backend="direct",
                         fused_integrate=True)
        out2 = simulate(cfg2, s2)
        rec["kernels"]["K5 config 2"] = {
            "n": N_CONFIG2, "block": cfg2.tile_i, "steps": STEPS_CONFIG2,
            "schedule": df.row_schedule(N_CONFIG2, cfg2.tile_i) if sched
            else None,
            "ms_per_step": time_fn(simulate, cfg2, s2, reps=REPS) * 1e3
            / STEPS_CONFIG2,
            "digest": digest(out2.pos, out2.vel)}
        # Below FLT_MIN the self pair's w overflows, so every row of a
        # square call is NaN: the rsqrtf form is digested on a rectangle of
        # two disjoint sets.
        dig = rec.setdefault("digests", {})
        a, b = pd[:N_DIGEST // 2], pd[N_DIGEST // 2:]
        for soft_d in DIRECT_SOFTENINGS:
            for case, m in (("unit masses", None), ("masses", md)):
                for block in DIGEST_BLOCKS:
                    key = f"soft {soft_d} {case} block {block}"
                    mb = None if m is None else m[N_DIGEST // 2:]
                    dig[f"K1 rect {key}"] = digest(df.body_force_direct(
                        a, b, mb, soft_d, block))
                    if soft_d < 2.0 ** -126:
                        continue
                    dig[f"K1 {key}"] = digest(df.body_force_direct(
                        pd, pd, m, soft_d, block))
                    dig[f"K5 {key}"] = digest(*df.euler_step_fused(
                        pd, vd, m, 1e-3, soft_d, block))
        if sched:
            sweep = rec.setdefault("sweep", {})
            for r in SWEEP_R:
                for rows in SWEEP_ROWS:
                    if rows % (32 * r) or rows < 256:
                        continue
                    args = (state.pos, state.pos, None, soft, r, rows)
                    sweep[f"K1 2^20 r {r} rows {rows}"] = {
                        "ms": time_fn(df.launch_direct, *args,
                                      reps=3) * 1e3,
                        "digest": digest(df.launch_direct(*args)),
                        **info("direct_force_info", r, rows, 0,
                               df.rsqrt_form(soft), 0)}
            for r in SWEEP_R:
                for rows in SWEEP_ROWS:
                    if rows % (32 * r):
                        continue
                    args = (s2.pos, s2.vel, None, cfg2.dt, cfg2.softening,
                            r, rows)
                    sweep[f"K5 config 2 r {r} rows {rows}"] = {
                        "ms": time_fn(df.launch_fused, *args,
                                      reps=REPS) * 1e3,
                        "digest": digest(*df.launch_fused(*args)),
                        **info("direct_force_info", r, rows, 0,
                               df.rsqrt_form(cfg2.softening), 1)}
            r1, rows1 = df.row_schedule(N, DIRECT_BLOCK)
            r5, rows5 = df.row_schedule(N_CONFIG2, cfg2.tile_i)
            rec["occupancy"] = {
                "K1": {"r": r1, "rows": rows1, **info(
                    "direct_force_info", r1, rows1, 0, df.rsqrt_form(soft),
                    0)},
                "K5": {"r": r5, "rows": rows5, **info(
                    "direct_force_info", r5, rows5, 0,
                    df.rsqrt_form(cfg2.softening), 1)}}

    if "pe" in only:
        def pe_rows(pos, m, soft_p, block=None):
            if sched:
                return pk.launch_rows(pos, m, soft_p, *(
                    pk.schedule(pos.shape[0]) if block is None
                    else df.row_schedule(pos.shape[0], block)))
            block = pk.BLOCK if block is None else block
            rows = torch.empty(pos.shape[0], device=dev)
            _build.check(lib, lib.pe_rows_launch(
                pos.data_ptr(), None if m is None else m.data_ptr(),
                pos.shape[0], rows.data_ptr(), soft_p, block, stream),
                "pe_rows_launch")
            return rows

        pr = torch.rand((N_PE_RAGGED, 3), generator=dgen, device=dev) * 2 - 1
        mr = torch.rand(N_PE_RAGGED, generator=dgen, device=dev) + 0.5
        for case, pos, m in (("masses", s3.pos, s3.mass),
                             ("unit masses", s3.pos, None),
                             (f"ragged {N_PE_RAGGED} masses", pr, mr)):
            rec["kernels"][f"K4 {case}"] = {
                "n": pos.shape[0],
                "schedule": pk.schedule(pos.shape[0]) if sched
                else (1, pk.BLOCK),
                "ms_per_launch": time_fn(pk.potential_energy_kernel, pos, m,
                                         SOFT_CONFIG3, reps=REPS) * 1e3,
                "u": pk.potential_energy_kernel(pos, m, SOFT_CONFIG3).item(),
                "digest": digest(pe_rows(pos, m, SOFT_CONFIG3))}
        dig = rec.setdefault("digests", {})
        for soft_p in PE_SOFTENINGS:
            for case, m in (("unit masses", None), ("masses", md)):
                for block in DIGEST_BLOCKS:
                    dig[f"K4 soft {soft_p} {case} block {block}"] = digest(
                        pe_rows(pd, m, soft_p, block))
        if sched:
            sweep = rec.setdefault("sweep", {})
            for r in SWEEP_R:
                for rows in SWEEP_ROWS:
                    if rows % (32 * r):
                        continue
                    args = (s3.pos, s3.mass, SOFT_CONFIG3, r, rows)
                    sweep[f"K4 262144 r {r} rows {rows}"] = {
                        "ms": time_fn(pk.launch_rows, *args,
                                      reps=REPS) * 1e3,
                        "digest": digest(pk.launch_rows(*args)),
                        **info("pe_rows_info", r, rows, 1)}
            r4, rows4 = pk.schedule(N_CONFIG3)
            rec.setdefault("occupancy", {})["K4"] = {
                "r": r4, "rows": rows4, **info("pe_rows_info", r4, rows4, 1)}

    # nvcc's report of the slot kernels, parsed by this tree's _build.
    rec["ptxas_log"] = "\n".join(
        ln for ln in _build.BUILD_LOG.splitlines()
        if "Compiling entry" in ln or "spill" in ln or "Used" in ln)
    occ = rec.pop("occupancy", {})
    # B12's query, and B10's without the side argument B12's two sides
    # needed, in a tree with the pair-once B12.
    pair_once = hasattr(lib, "vjp_pair_info")
    for name, fn, args in (("K3", "symmetric_force_info", (3, tile, fast)),
                           ("K2", "slot_pipe_info", (tile, 0)),
                           ("B6", "mxu_force_info", (1, 1)),
                           ("B16", "band_mxu_info", (tile, 0, fast)),
                           ("B14", "vjp_rect_mxu_info", (128, 1)),
                           ("B10", "vjp_ordered_info",
                            (512, 1) if pair_once else (0, 512, 1)),
                           ("B11", "vjp_sym_info", (64, 1, 3)),
                           ("B13", "vjp_mxu_info", (128, 1, 8)),
                           ("B12", "vjp_pair_info" if pair_once
                            else "vjp_ordered_info",
                            (1,) if pair_once else (1, 512, 1))):
        if hasattr(lib, fn):
            out = (ctypes.c_int * 4)()  # the VJPs' add threads
            _build.check(lib, getattr(lib, fn)(*args, ctypes.addressof(out)),
                         fn)
            occ[name] = {"registers": out[0], "local_bytes": out[1],
                         "ctas_per_sm": out[2], "from": fn}
            if name in ("B14", "B10", "B11", "B13", "B12"):
                occ[name]["threads"] = out[3]
    rec["occupancy"] = occ
    direct = ("direct_force_kernel", "pe_rows_kernel")
    dump = sass_dir is not None and {"direct", "pe"} & set(only)
    rec["sass_loops"] = kernel_sass(lib._name, [
        m for k in ("B14", "B10", "B11", "B13") for m in SLOT_KERNELS[k]]
        + list(B12_SASS) + list(direct), dump=direct if dump else (),
        dump_to=os.path.join(
            sass_dir, f"ab_sass_{os.path.basename(os.path.abspath(tree))}"
            ".txt") if dump else None)
    rec["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other tree's root")
    ap.add_argument("--turns", default="other,this,this,other")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="the worker's sections to run, comma-separated")
    ap.add_argument("--sass-dir", help="where the SASS text of K1, K5 "
                    "and K4 goes (direct, pe)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = args.only.split(",")
    if not set(only) <= set(SECTIONS):
        sys.exit(f"--only takes sections of {SECTIONS}")
    if args.worker:
        worker(args.worker, only, args.sass_dir)
        return
    import torch

    from mini_nbody_tpu_torch import _build

    if not torch.cuda.is_available():
        sys.exit("ab_slots.py needs one card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    if args.other is None:
        sys.exit("ab_slots.py needs --other DIR")
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"this": here, "other": os.path.abspath(args.other)}
    for turn in args.turns.split(","):
        sass = ([] if args.sass_dir is None
                else ["--sass-dir", os.path.abspath(args.sass_dir)])
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", trees[turn], "--only", args.only,
                            *sass],
                           cwd=trees[turn],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout, r.stderr[-4000:], file=sys.stderr)
            sys.exit(f"worker for {turn} failed")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        report = _build.ptxas_report(rec.pop("ptxas_log"))
        rec["ptxas"] = {k: v for k, v in report.items()
                        if any(m in k for ms in SLOT_KERNELS.values()
                               for m in ms)}
        skip = {"K1", "K5"} - ({"K1", "K5"} if "direct" in only else set())
        skip |= {"K4"} - ({"K4"} if "pe" in only else set())
        for name, mangled in SLOT_KERNELS.items():
            regs = find_kernel(report, mangled).get("registers")
            if name not in rec["occupancy"] and name not in skip \
                    and regs is not None:
                rec["occupancy"][name] = {
                    "registers": regs, "from": "computed",
                    "ctas_per_sm": ctas_per_sm(regs,
                                               *SHARED_W_BODIES[name])}
        print(json.dumps({"turn": turn, **rec}), flush=True)


if __name__ == "__main__":
    main()
