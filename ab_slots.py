"""Times the pair-once slot kernels K3 and K2 of two trees of this repo on
one card, in turns, on the same inputs.

    python3 ab_slots.py --other DIR [--turns other,this,this,other]

DIR is another checkout of the repo (for example the parent commit unpacked
with ``git archive``, in a directory that .gitignore lists). Each turn runs
one worker process with that tree's ``mini_nbody_tpu_torch`` first on
``sys.path``; the worker builds the tree's kernels from its own sources and
prints one JSON line:
- per kernel (K3 and K2, tri and cross mode, N = 2^20's chunk 131,072 at tile
  128, unit masses; K2 maskless, and masked as 'auto' runs it): the kernel
  launches of one call alone (no slot_reduce), their ms per launch, and the
  error of the (maskless) call's sums
  against the tree's plain version (K3 per element at the K1 bound's scale,
  K2 per column scale against the bf16-mode plain sums);
- the ms of a whole N = 2^20 force pass on ``auto`` (K3) and ``sym_mxu``
  (K2);
- B15 on config 1 (N = 4096, 10 Euler steps, dt 0.01) in both classes, ms
  per launch;
- nvcc's ptxas report for the slot kernels (registers, spill bytes), and
  CTAs per SM: from the kernel's own occupancy query where the tree has one
  (``symmetric_force_info`` / ``slot_pipe_info``), else computed from the
  registers, threads and shared memory of the body (H100: 65,536 registers,
  2048 threads, 32 CTAs and 233,472 bytes of shared memory per SM).
The parent prints the same lines, so the two trees are compared within one
call on one card. The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N, CHUNK, TILE, SEED = 1 << 20, 131072, 128, 0
N_CONFIG1, STEPS_CONFIG1, DT_CONFIG1 = 4096, 10, 0.01
REPS = 5
#: Threads and dynamic shared memory per CTA of the tile-128 slot bodies
#: before the register designs (a T x T w tile in shared memory: K3 2T
#: threads, (T (T + 1) + 8 T) floats; K2 256 threads, the bf16 W tile of T
#: (T + 8), v_a, v_b and the positions), for trees without an occupancy
#: query.
SHARED_W_BODIES = {"K3": (256, 70144), "K2": (256, 76800)}
#: The main path's instantiations: K3 at tile 128, unit masses, fast rsqrt;
#: K2 at tile 128 without split_w (a part of each mangled name).
SLOT_KERNELS = {"K3": "symmetric_force_kernelILi128ELi3ELb1E",
                "K2": "slot_pipe_kernelILi128ELb0E"}


def ctas_per_sm(regs, threads, smem):
    """CTAs per SM of an H100 from a kernel's registers, threads and dynamic
    shared memory (registers allocated per warp in units of 256)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def worker(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import ctypes

    import torch

    from mini_nbody_tpu_torch import SimConfig, _build, init
    from mini_nbody_tpu_torch.ops import resident_sym as rs
    from mini_nbody_tpu_torch.ops import slot_pipe as sp
    from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
    from mini_nbody_tpu_torch.ops import symmetric_force as sf
    from mini_nbody_tpu_torch.ops.force import make_force_fn
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
           "tile": tile, "kernels": {}}

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
    for mode, table in slots.items():
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
                                        "err_of_scale": err}

    # K2 (unit masses, maskless, no split).
    p, v = sm._pack(state.pos, None, N, np_)
    for mode, table in slots.items():
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
                                        "err_of_scale": err}

    for backend in ("auto", "sym_mxu"):
        f = make_force_fn(SimConfig(n=N, backend=backend, sym_chunk=CHUNK))
        rec[f"pass_ms_{backend}"] = time_fn(f, state.pos, state.pos,
                                            reps=3) * 1e3
    s1 = init.uniform_random(N_CONFIG1, generator=gen, device=dev)
    for mxu in (False, True):
        rec[f"b15_config1_ms_{'bf16' if mxu else 'fp32'}"] = time_fn(
            lambda: rs.simulate_resident_sym(s1.pos, s1.vel, None,
                                             steps=STEPS_CONFIG1,
                                             dt=DT_CONFIG1, mxu=mxu),
            reps=REPS) * 1e3

    # nvcc's report of the slot kernels, parsed by this tree's _build.
    rec["ptxas_log"] = "\n".join(
        ln for ln in _build.BUILD_LOG.splitlines()
        if "Compiling entry" in ln or "spill" in ln or "Used" in ln)
    occ = {}
    for name, fn, args in (("K3", "symmetric_force_info", (3, tile, fast)),
                           ("K2", "slot_pipe_info", (tile, 0))):
        if hasattr(lib, fn):
            out = (ctypes.c_int * 3)()
            _build.check(lib, getattr(lib, fn)(*args, ctypes.addressof(out)),
                         fn)
            occ[name] = {"registers": out[0], "local_bytes": out[1],
                         "ctas_per_sm": out[2], "from": fn}
    rec["occupancy"] = occ
    rec["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other tree's root")
    ap.add_argument("--turns", default="other,this,this,other")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return
    import torch

    from mini_nbody_tpu_torch import _build

    if not torch.cuda.is_available():
        sys.exit("ab_slots.py needs one card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"this": here, "other": os.path.abspath(args.other)}
    for turn in args.turns.split(","):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", trees[turn]], cwd=trees[turn],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout, r.stderr[-4000:], file=sys.stderr)
            sys.exit(f"worker for {turn} failed")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        report = _build.ptxas_report(rec.pop("ptxas_log"))
        rec["ptxas"] = {k: v for k, v in report.items()
                        if any(m in k for m in SLOT_KERNELS.values())}
        for name, mangled in SLOT_KERNELS.items():
            regs = next((v["registers"] for k, v in report.items()
                         if mangled in k), None)
            if name not in rec["occupancy"] and regs is not None:
                rec["occupancy"][name] = {
                    "registers": regs, "from": "computed",
                    "ctas_per_sm": ctas_per_sm(regs,
                                               *SHARED_W_BODIES[name])}
        print(json.dumps({"turn": turn, **rec}), flush=True)


if __name__ == "__main__":
    main()
