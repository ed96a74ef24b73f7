"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--bwd-tile 64|128]

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
  the unfused ``direct`` run;
- ``grad_config3``: the differentiable path at config 3's N = 262,144: the
  gradient of a 10-step "sqrt"-checkpointed leapfrog rollout on ``auto``
  (forward K3, backward B11: the card's route keeps the pair-once
  backwards at every N), one B11 and one B10 call against the plain VJP,
  then 5 Adam iterations of examples/optimize_impact.py's probe loss;
- ``grad_sym``: the same rollout gradient at N = 65,536 (backward B11)
  against the rollout on the kernels' plain versions, and B11's mass
  cotangent;
- ``grad_sym_mxu``: the rollout on ``sym_mxu`` at N = 65,536 and N =
  262,144 (backward B13) against the fp32 gradients, B13's raw sums at
  262,144 (last self chunk, chunk pair (0, last)) and one B14 launch there
  against their bf16-mode plain versions;
- ``mxu_main_path``: ``simulate``, one Euler step at N = 1,048,576 on ``mxu``
  with pair_dtype "bfloat16" (B6), forces checked against the float64
  oracle;
- ``config3_mxu_drift``: config 3 as the BASELINE writes it, in the
  bf16-pair class: ``mxu``/bfloat16, 1000 leapfrog steps (B6), energies
  through K4, the drift gate 1e-5;
- ``grad_mxu``: the rollout gradient on ``mxu``/bfloat16 at N = 65,536
  (forward B6, backward B13) against ``grad_sym``'s fp32 gradient;
- ``pair_mxu``: ``body_force_pair_mxu`` (B4, K2's cross mode over a
  rectangle) on the two halves of config 3's state, against the B6
  rectangles and the float64 oracle;
- ``determinism``: K2, K3, B11, B13, B16, B10 and B14 twice at N =
  262,144 (two chunks: tri and cross launches; B10 and B14 one square
  launch each), bitwise equal; ``sym_mxu`` with 'auto' and 'fast' bitwise
  'masked' at N = 65,536 on the slots and on the band, B10's and B14's
  'fast' bitwise their 'masked' at 262,144; a 10-step rollout gradient
  with remat "sqrt" bitwise the one with "none", on ``auto`` and
  ``sym_mxu``, at N = 65,536 and at 262,144 (backward B11 and B13);
- ``ensemble_sweep``: examples/parameter_sweep.py at its defaults, B = 32
  plummer spheres of N = 1024 with velocity scales 0.2 .. 1.6, 200 leapfrog
  steps of ``simulate_ensemble`` on ``sym_mxu`` (B9a): per-system energy
  drift, the sweep trend, systems 0 and 31 bitwise their ``simulate``;
- ``ensemble_fp32``: B = 16 plummer systems of config 2's N = 65,536 on
  ``auto`` (B9b), 5 leapfrog steps, each system bitwise its ``simulate``;
- ``trajectory``: N = 65,536 on ``auto``, 20 steps with a snapshot every 5,
  the last snapshot bitwise ``simulate``'s final positions;
- ``coincident_gate``: for each kernel behind a coincident gate (K2, B16,
  B6, B10, B11, B13, B14), 'masked' against the duplicate scan plus the
  maskless kernel at N = 4096 .. 262,144;
- ``grad_ensemble``: gradients of sum(sin(F)) through
  ``make_differentiable_ensemble_force`` for B = 16 plummer systems of
  config 2's N = 65,536 with masses, on ``sym`` (forward B9b, backward
  B9c) and ``sym_mxu`` (B9a, B9d): every system bitwise its standalone
  VJP at the same tile, the mass cotangent too, no gradient in other
  systems from a loss on system 0, 16 x 4096 in one launch, and each
  kernel against its plain version at 3 x 4096;
- ``resident``: the resident kernel B15 (one launch per trajectory, the
  end passes of leapfrog and Yoshida-4 included) in both classes:
  BASELINE config 1 (N = 4096 uniform, 10 Euler steps, dt 0.01) against
  the streamed run, 200 leapfrog and Yoshida-4 steps at 4096, config 2's
  N = 65,536 with masses, the cap N = 131,072,
  examples/parameter_sweep.py's defaults on the resident ensemble (one
  launch; systems 0 and 31 bitwise their standalone resident runs),
  reruns and a split Yoshida-4 phase bitwise, a 'fast' fold over pads
  finite, B15 against its plain version at N = 1000, config 1's leapfrog
  and Yoshida-4 call times, and B15's registers, spills and CTAs per SM;
- ``resident_crossover``: ms per step of B15 (fold on and off) against the
  streamed loop at N = 512 .. 32,768, and of the resident ensemble against
  B9a / B9b at (B, N) = (256, 256) .. (4, 16384): the card's crossovers;
  then whole calls of 2-20 steps of each integrator, routed and streamed;
- ``band_main_path``: ``simulate`` at N = 1,048,576 on ``sym_mxu`` with
  ``traversal='band'`` (B16), 2 Euler steps: B16's tri and cross launches
  and no K2 launch, forces against the float64 oracle and against the slot
  traversal, the step time beside ``main_path``'s K2 step;
- ``config3_band_drift``: config 3 on the band (B16), 1000 leapfrog steps,
  energies through K4, the drift gate 1e-5;
- ``band_ensemble``: ``body_force_sym_mxu_ensemble(traversal='band')`` (B16's
  ensemble mode) on the parameter sweep's 32 x 1024 and on 16 x 65,536
  with masses: every system bitwise its standalone band call, the distance
  from B9a's slot result;
- ``sharded``: the sharded path (``parallel/``) on a one-rank NCCL group
  over ``make_mesh((1,))`` and ``make_mesh((1, 1))``: BASELINE config 4's
  N = 1,048,576, 2 Euler steps of ``simulate_sharded`` under
  ``all_gather``, ``ring`` and ``ring_sym`` on ``auto``, ``grid`` on
  ``direct`` and ``all_gather`` on ``sym_mxu``, each bitwise the
  single-card ``simulate`` on the kernel its shard runs, with exact kernel
  and collective counts and the ms per step beside the single card's;
  config 3 (plummer, N = 262,144) through one differentiable step under
  ``grid`` (backward B12, one launch per piece of its slots) and ``ring``
  on ``sym_mxu`` (backward B14) against the single-card gradient (B11); the
  parameter
  sweep with a mesh, bitwise the unsharded ensemble.

Then, after the kernels' timings and before the kernels line, the port's
entry points as users call them (``mini_nbody_tpu_torch.cli`` in process,
the demos as modules):

- ``cli_check``: ``nbody-torch check`` at N = 262,144 on ``sym`` and on
  ``sym_mxu`` (plummer): JAX's gates pass;
- ``cli_run_resume``: 10 + 10 Euler steps at N = 65,536 through ``--save``
  / ``--resume``, bitwise a 20-step ``simulate``;
- ``cli_bench``: ``bench`` at N = 1,048,576 on ``sym_mxu``, ``direct``,
  ``auto`` and ``mxu``/bfloat16: ``roofline_frac`` in (0, 1], beside the
  value PERF.md's times predict;
- ``cli_shmoo``: ``shmoo`` over N = 4096 .. 262,144 on ``auto``, the 4096
  row on the resident kernel;
- ``cli_tune``: ``tune`` at N = 262,144 on ``sym`` into a temporary cache,
  which ``run --autotune`` then reads without measuring;
- ``trace``: 2 steps under ``utils/tracing.profile_trace`` in ``annotate``
  spans: the Chrome trace holds the span, the program's ``nbody.force``
  span of each step and K3's kernel; under ``emit_nvtx()`` (Nsight's ranges)
  the span's gate reads the profiler as on;
- ``examples``: the six demos of examples/torch at quick sizes;

and ``sharded`` also writes its state with ``save_sharded`` and restores it
with ``load_sharded``, bitwise, with no collective.

B16 makes one launch per piece of its row blocks
(``sym_mxu_force.BAND_PIECE_TILES``) and group of systems, each followed by
one launch of ``csrc/slot_reduce.cu`` that adds the piece's column partials
in increasing row block. A slot kernel (K2, K3, B11, B12, B13, and the
ensembles B9a and B9b) makes one launch per piece of its slot list
(``slot_pipe.PIECE_SLOTS`` slots) and group of systems, each followed by
one launch of ``csrc/slot_reduce.cu``, which adds the piece's partial sums
in slot order; the launch counts and the per-launch times of the kernels
line count those launches.

Before the paths, ``vjp_vs_plain`` holds the VJP kernels B10, B11, B13 and
B14 against their plain versions, ``b6_vs_plain`` and ``b4_vs_plain``
hold B6 and B4 against theirs, ``band_vs_plain`` holds B16 (the band
traversal) against its plain version in its tri, cross and ensemble modes
(one block, odd with a ragged tail, even; masked and maskless; masses;
split_w; each call twice, bitwise) and on one whole tri call at c =
131,072 with masses, and ``b12_vs_plain`` holds B12
(``vjp_pos_pair``, the grid backward) against its plain version on the
tiles of 2 x 2 and 4 x 2 grids at N = 262,144, a ragged pair and the whole
262,144 x 262,144 pair matrix the sharded grid gradient gives it. Then it
times each kernel beside its plain version and its bound; the records of
the register bodies and of B10, B11, B12, B13, B14, B9c and B9d carry
their registers, local bytes and CTAs per SM from the kernels' occupancy
queries. Every phase prints one JSON line; the line before the last is the
card's name and power limit from nvidia-smi, preceded by one JSON line of
per-kernel results, and the last line is ``{"ok": true, "device": {...}}``.
Any failure raises: the traceback is printed, the exit code is non-zero and
the ok line is never printed. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from mini_nbody_tpu_torch import (BodyState, SimConfig, _build, init,
                                  make_differentiable_ensemble_force,
                                  make_differentiable_force, make_force_fn,
                                  make_mesh, make_rollout_fn, simulate,
                                  simulate_ensemble, simulate_sharded,
                                  trajectory)
from mini_nbody_tpu_torch.parallel import _comm
from mini_nbody_tpu_torch.parallel import sharded as psh
from mini_nbody_tpu_torch import sim as tsim
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
from mini_nbody_tpu_torch.ops.reference import body_force_torch
from mini_nbody_tpu_torch.sim import init_carry
from mini_nbody_tpu_torch.utils.config import (SOFTENING, SYM_BWD_TILES,
                                               fast_rsqrt_cube)
from mini_nbody_tpu_torch import cli
from mini_nbody_tpu_torch.utils import autotune, harness, tracing
from mini_nbody_tpu_torch.utils import checkpoint as ckpt
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

#: H100 SXM peaks (utils/harness.py CHIP_PEAKS): fp32 outside the tensor
#: cores, dense bf16 on the tensor cores, the special-function unit's rsqrt
#: rate (one rsqrt per unordered pair of the pair-once slot bodies K2, K3
#: and the kernels on them: B4, B9a, B9b, B15) and device memory.
PEAKS = harness.CHIP_PEAKS["h100"]
#: fp32 operations per pair for the bounds (utils/harness.py: 20 an ordered
#: interaction, 24 / 26 a pair-once evaluation, K2's 12 fp32 + 32 bf16);
#: the potential is 12 per ordered pair.
OPS_ORDERED, OPS_PAIR_ONCE, OPS_PAIR_ONCE_MASS = (
    harness.OPS_ORDERED, harness.OPS_PAIR_ONCE, harness.OPS_PAIR_ONCE_MASS)
OPS_K2_FP32, OPS_K2_MMA, OPS_PE = harness.OPS_K2_FP32, harness.OPS_K2_MMA, 12
#: K5's epilogue per body: v' = v + dt F and p' = p + dt v'.
OPS_EULER = 12

#: K1 vs its plain version and vs the fp64 oracle: fp32 sums of up to 2^20
#: terms in different orders (and FMA contraction in the kernel) drift by
#: ~sqrt(N) * 2^-24 of the partial sums, ~6e-5 of the largest force.
K1_RTOL, K1_ATOL = 1e-3, 1e-4
#: K2 raw sums vs the bf16-mode plain sums, per column scale: both round w
#: and v to bf16 the same way, but FMA contraction can move a w across a
#: bf16 rounding boundary (one pair term off by 2^-8), and the kernel sums
#: in another order.
K2_ATOL = 2e-3
#: sym_mxu forces vs the fp64 oracle: the on-card bf16-accumulate bound of
#: tests/test_slot_pipe.py:24.
SYM_RTOL, SYM_ATOL = 2e-2, 5e-3
#: K3 vs its plain version: fp32 sums in another order, the K1 bound.
#: K4's U against its plain version and a float64 oracle.
K3_RTOL, K3_ATOL = K1_RTOL, K1_ATOL
K4_RTOL = 1e-5
#: K5 (fused) against the unfused direct run: the epilogue rounds as the
#: unfused PyTorch update does and the force loop is K1's. Against its plain
#: version K5 is held to K1's bound.
K5_RTOL, K5_ATOL = 1e-4, 1e-5
#: Time the plain version at N_MAIN only if 16x its time at N_MAIN / 4 fits.
PLAIN_MAX_S = 60.0

#: The differentiable path: a GRAD_STEPS-step "sqrt" rollout gradient at
#: config 3's N and at N_GRAD_SYM, the backward size of
#: benchmarks/RESULTS.md (B11, B13 at both: the card's route keeps the
#: pair-once backwards at every N); then
#: ADAM_ITERS Adam iterations of examples/optimize_impact.py's probe loss
#: over ADAM_STEPS steps of its dt.
GRAD_STEPS, N_GRAD_SYM = 10, 65536
#: Two losses of the final state: sum(pos^2), whose gradient in the initial
#: positions is 2 pos_final plus ~1e-6 of it through the forces (masses
#: 1/N, 10 steps of dt 1e-3), and sum(vel^2), whose gradient flows through
#: the force VJPs alone, so the gradient comparisons use it. Backward
#: launches: the last step's force feeds only the final velocity and
#: acceleration, so under the position loss it gets no VJP.
GRAD_VJPS = {"pos": GRAD_STEPS - 1, "vel": GRAD_STEPS}
ADAM_ITERS, ADAM_STEPS, ADAM_DT = 5, 20, 5e-3
#: Operations per pair for the VJP bounds (the JAX cost estimates): B10 35
#: fp32 per ordered pair (vjp_kernel.py:656); B11 22 per ordered pair, so 44
#: per unordered pair, 52 with the mass cotangent (vjp_kernel.py:433); B13
#: 30 fp32 (w, c; vjp_mxu.py:367) per unordered pair and 64 bf16 on the
#: tensor cores (two sides x [w | c] against 16 operand columns); B14 30
#: fp32 and 32 bf16 per ordered pair (one side; vjp_mxu.py:681).
OPS_B10, OPS_B11, OPS_B11_MASS = 35, 44, 52
OPS_B13_FP32, OPS_B13_MMA, OPS_B14_FP32, OPS_B14_MMA = 30, 64, 30, 32
#: B6 per ordered pair (utils/harness.py): w in fp32 (12, the rsqrt
#: counted as 1; 13 with a mass) and, in the bf16 class, 8 operand columns
#: x 2 on the tensor cores.
OPS_B6_FP32, OPS_B6_MASS, OPS_B6_MMA = (
    harness.OPS_B6_FP32, harness.OPS_B6_MASS, harness.OPS_B6_MMA)

#: The determinism phase's N: two chunks of CHUNK, so tri and cross
#: launches.
N_DETERMINISM = 262144
#: examples/parameter_sweep.py's defaults (B9a), and B = 16 systems of
#: config 2's N on 'auto' (B9b); the trajectory phase.
SWEEP_B, SWEEP_N, SWEEP_STEPS, SWEEP_DT, SWEEP_SOFT = 32, 1024, 200, 2e-3, 1e-3
ENS_B, ENS_N, ENS_STEPS, ENS_SMALL_N = 16, 65536, 5, 4096
N_TRAJ, TRAJ_STEPS, TRAJ_EVERY = 65536, 20, 5
#: The sizes of the coincident_gate phase and its timed calls per mode.
GATE_NS = (4096, 8192, 16384, 32768, 65536, 131072, 262144)
GATE_REPS = 6
#: grad_ensemble: B = 16 systems of config 2's N (the B9b shape), one case
#: of 16 x 4096 (every system in one launch) and the plain check at 3 x
#: 4096.
GENS_B, GENS_N, GENS_SMALL_N, GENS_CHECK_B = 16, 65536, 4096, 3
#: resident: BASELINE config 1 (configs[0]: N = 4096, 10 Euler steps, dt
#: 0.01, uniform, the default softening); 200 leapfrog and Yoshida-4 steps
#: at its N; config 2's N with masses; the cap; the plain check.
N_CONFIG1, STEPS_CONFIG1, DT_CONFIG1 = 4096, 10, 0.01
RES_LONG_STEPS, RES_CONFIG2_STEPS, RES_CAP_STEPS = 200, 10, 2
RES_PLAIN_N, RES_PLAIN_STEPS = 1000, 5
#: B15's class bounds (tests/test_resident_sym.py:21-48), here for C4's
#: 'fast' fold against 'masked': fp32 rtol 1e-4, atol 1e-5 of the scale;
#: bf16 rtol 2e-2, atol 2e-3 of the scale. Against the streamed path B15 is
#: held bitwise.
RES_FP32, RES_BF16 = (1e-4, 1e-5), (2e-2, 2e-3)
#: B15 against its plain version (bf16 mode in the bf16 class): the change
#: of each body's velocity and position over the run, each within this
#: share of its own scale (max |plain change|), per case, as (fp32 class,
#: bf16 class). A B15 that dropped the forces is off by the whole scale.
#: Measured on an H100 (the larger of the two changes): config 1, one step,
#: 3.8e-7 and 1.5e-4; its 10 steps (softening 1e-9, chaotic) 5.4e-4 and
#: 9.7e-3; RES_PLAIN_N plummer bodies with masses 1.2e-5 in both (the
#: rounding of v itself against a small change).
RES_PLAIN_TOL = {"config1_1step": (4e-6, 2e-3), "config1": (5e-3, 5e-2),
                 "plummer": (1e-4, 1e-4)}
#: resident_crossover: the sizes of JAX's crossover probes (sim.py:205-217)
#: and the next size up of each, Euler steps per timed run, timed runs per
#: variant (turns interleaved).
CROSS_NS = (512, 1024, 2048, 4096, 8192, 16384, 32768)
CROSS_ENS = ((256, 256), (64, 1024), (32, 2048), (16, 4096), (8, 8192),
             (4, 16384))
CROSS_STEPS, CROSS_REPS = 100, 5
#: The short runs of resident_crossover: whole simulate calls of this many
#: steps, each integrator, routed (resident=True) against the streamed loop
#: at the sizes of CROSS_NS and CROSS_ENS up to these per-system N (where
#: B15 won at CROSS_STEPS steps).
CROSS_SHORT_STEPS = (2, 3, 5, 10, 20)
CROSS_SHORT_MAX_N, CROSS_SHORT_MAX_ENS_N = 32768, 16384
#: B15's fp32 operations per unordered pair and step in the fp32 class
#: (JAX's cost estimate, resident_sym.py:656, :796; below K3's 24, so the
#: bound is if anything short) and its bytes per body (state in and out).
#: The bf16 class runs K2's slot body and takes K2's count (OPS_K2_FP32 and
#: OPS_K2_MMA).
OPS_B15, BYTES_B15 = 19, 64
#: B12: JAX's count, 26 fp32 operations per ordered pair
#: (vjp_kernel.py:944); its two one-sided launches do ~22 each. Its checks:
#: the tiles a device of a 2 x 2 and a 4 x 2 grid holds at config 3's N
#: (row group x column group, sharing half or a quarter of their bodies),
#: and a ragged pair; its time on the whole pair matrix (a 1 x 1 grid).
OPS_B12 = 26
B12_TILES = ((2, 2), (4, 2))
B12_RAGGED = (3001, 9001)
#: sharded: Euler steps at N_MAIN per comm.
SHARDED_STEPS = 2
#: The CLI phases: check at N_CLI_CHECK; 10 + 10 Euler steps through
#: --save / --resume at N_CLI_RUN; bench at N_MAIN, each backend beside the
#: roofline_frac PERF.md's card times predict (bound / pass time: sym_mxu
#: 131.5 / 477 ms, direct 328.2 / 526.4, auto 196.9 / 492.9, mxu with
#: bf16 pairs 262.9 / 559); the shmoo's sizes (4096 routes B15); tune at
#: N_CLI_TUNE.
N_CLI_CHECK, N_CLI_RUN, CLI_RUN_STEPS, N_CLI_TUNE = 262144, 65536, 10, 262144
CLI_BENCH = ((["--backend", "sym_mxu"], 0.28), (["--backend", "direct"], 0.62),
             (["--backend", "auto"], 0.40),
             (["--backend", "mxu", "--pair-dtype", "bfloat16"], 0.47))
CLI_SHMOO_SIZES = (4096, 16384, 65536, 262144)
#: The trace phase: 2 steps at N_TRACE on auto (K3).
N_TRACE = 65536
#: Each example of examples/torch at a quick size on the card.
EXAMPLES = (("cold_collapse", ["--n", "8192", "--steps", "100",
                                "--interval", "50"]),
            ("infer_masses", ["--n", "16", "--steps", "10", "--iters",
                              "120"]),
            ("optimize_impact", []),
            ("parameter_sweep", []),
            ("reference_envelope", None),
            ("multihost_cpu", None))

DEV = torch.device("cuda", 0)


def fail(msg):
    raise RuntimeError(msg)


def line(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def close(got, want, rtol, atol_scale, what, floor=1.0):
    """Raise unless |got - want| <= rtol |want| + atol_scale * scale, the
    scale max|want| but at least ``floor`` (0 for gradients, whose scale
    is their own); returns the max abs error."""
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    scale = max(want.abs().max().item(), floor)
    err = (got - want).abs()
    bad = err > rtol * want.abs() + atol_scale * scale
    if bad.any():
        fail(f"{what}: {int(bad.sum())} elements out of bound, max err "
             f"{err.max().item():.4g}, scale {scale:.4g}")
    return err.max().item()


def close_grad(got, want, rtol, atol_scale, what):
    """close() for a gradient or VJP: atol against its own max|want|."""
    return close(got, want, rtol, atol_scale, what, floor=0.0)


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


#: The launch counters of read_counts: its name -> the registry's
#: (utils/tracing.counters).
COUNTERS = {"direct": "launch.K1", "fused_euler": "launch.K5",
            "slot_tri": "launch.K2.tri", "slot_cross": "launch.K2.cross",
            "pair_mxu": "launch.B4", "mxu": "launch.B6",
            "sym_tri": "launch.K3.tri", "sym_cross": "launch.K3.cross",
            "pe": "launch.K4", "vjp_ordered": "launch.B10",
            "vjp_sym_tri": "launch.B11.tri",
            "vjp_sym_cross": "launch.B11.cross",
            "vjp_mxu_tri": "launch.B13.tri",
            "vjp_mxu_cross": "launch.B13.cross",
            "vjp_rect_mxu": "launch.B14", "slot_ensemble": "launch.B9a",
            "sym_ensemble": "launch.B9b", "vjp_sym_ensemble": "launch.B9c",
            "vjp_mxu_ensemble": "launch.B9d", "resident": "launch.B15",
            "vjp_pair": "launch.B12", "slot_reduce": "launch.slot_reduce",
            "band_tri": "launch.B16.tri", "band_cross": "launch.B16.cross",
            "band_ensemble": "launch.B16.ensemble",
            "band_reduce": "launch.band_reduce"}
#: The registry's counts at the last reset_counts.
_COUNTS_AT_RESET = tracing.counters()
#: The slot kernels of read_counts: slot_reduce runs once after each of
#: their launches (B15 adds its partials inside its own launch).
SLOT_KERNELS = ("slot_tri", "slot_cross", "pair_mxu", "slot_ensemble",
                "sym_tri", "sym_cross", "sym_ensemble", "vjp_sym_tri",
                "vjp_sym_cross", "vjp_mxu_tri", "vjp_mxu_cross",
                "vjp_sym_ensemble", "vjp_mxu_ensemble", "vjp_pair")


#: B16's modes. csrc/slot_reduce.cu runs once after each launch that stores
#: column partials: every launch but those of a one-block self chunk, whose
#: callers give band_reduce.
BAND_KERNELS = ("band_tri", "band_cross", "band_ensemble")


def reset_counts():
    global _COUNTS_AT_RESET
    _COUNTS_AT_RESET = tracing.counters()


def expect_calls(path, **want):
    """Fail unless the sharded path made exactly ``want`` collective calls
    since reset_counts (the registry's ``comm.*``); returns them."""
    now = tracing.counters()
    got = {k: now[f"comm.{k}"] - _COUNTS_AT_RESET[f"comm.{k}"]
           for k in _comm.COLLECTIVES}
    full = dict(dict.fromkeys(got, 0), **want)
    if got != full:
        fail(f"{path}: collectives {got}, expected {full}")
    return got


def read_counts():
    """Launches per kernel (tri and cross modes apart) since reset_counts."""
    now = tracing.counters()
    return {k: now[name] - _COUNTS_AT_RESET[name]
            for k, name in COUNTERS.items()}


def expect_counts(got, path, **want):
    """Fail unless the path launched exactly ``want`` and nothing else;
    slot_reduce, unless given, once per launch of a slot kernel, and
    band_reduce once per B16 launch."""
    full = dict.fromkeys(got, 0)
    full.update(want)
    if "slot_reduce" not in want:
        full["slot_reduce"] = sum(full[k] for k in SLOT_KERNELS)
    if "band_reduce" not in want:
        full["band_reduce"] = sum(full[k] for k in BAND_KERNELS)
    if got != full:
        fail(f"{path}: launch counts {got}, expected {full}")


def tri_slots(c, tile):
    """Slots of a self chunk of c rows: each block pair once, the diagonal
    blocks folded in twos (slot_pipe.tri_slot_list)."""
    nb = c // tile
    return nb * (nb - 1) // 2 + ((nb + 1) // 2 if nb > 1 else 1)


def per_call(n_slots, n_sys=1):
    """Launches of one call of a slot kernel over n_slots slots and n_sys
    systems (slot_pipe.run_slot_pieces): one per piece of PIECE_SLOTS slots
    and group of systems, a group as many systems as keep a launch at or
    under PIECE_SLOTS slots, at most 65,535."""
    piece = sp.PIECE_SLOTS
    group = min(n_sys, max(1, piece // min(n_slots, piece)), 65535)
    return -(-n_slots // piece) * -(-n_sys // group)


def pass_launches(n, tile, passes=1):
    """(tri, cross) launches of ``passes`` chunked pair-once passes over n
    bodies at CHUNK (K2, K3, B11 or B13 at ``tile``)."""
    tile, c, nc, _ = sm._resolve_tiling(n, tile, CHUNK, kernel=True)
    return (passes * nc * per_call(tri_slots(c, tile)),
            passes * nc * (nc - 1) // 2 * per_call((c // tile) ** 2))


def reduce_ms(slots, tri, tile, width, rows, n_sys=1):
    """CUDA-event ms of the slot_reduce launches of one call of a slot
    kernel over ``slots`` on chunks of ``rows`` rows: run_slot_pieces with
    a compute launch that does nothing (the sums are of whatever the
    scratch holds)."""
    acc_a = torch.zeros((rows * n_sys, width), device=DEV)
    acc_b = acc_a if tri else torch.zeros_like(acc_a)

    def run():
        sp.run_slot_pieces("none", slots, tri, tile, width, acc_a, acc_b,
                           lambda *a: 0, lambda: None, n_sys, rows)

    return time_fn(run, reps=3) * 1e3


def slot_entry(name, source, replaces, launches, err, call_ms, red_ms, per,
               plain_call_ms, bnd, **kw):
    """entry() of a slot kernel, per launch: one call of ``per`` launches
    took call_ms, red_ms of it in its slot_reduce launches; its plain
    version took plain_call_ms and its bound is bnd."""
    bnd = {**bnd, "bound_ms": bnd["bound_ms"] / per}
    return entry(name, source, replaces, launches, err,
                 (call_ms - red_ms) / per, plain_call_ms / per, bnd,
                 call_ms=call_ms, slot_reduce_ms=red_ms,
                 launches_per_call=per, **kw)


def bound(fp32_ops, nbytes, bf16_ops=0.0, rsqrts=0.0):
    """The least time the card could take (utils/harness.bound at the H100
    peaks): the largest of the fp32 operations, the tensor-core operations
    and the rsqrts over their rates (the pipes run at once) and the bytes
    over the memory rate."""
    return harness.bound(fp32_ops, nbytes, bf16_ops, rsqrts, PEAKS)


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


#: The register bodies as their timed paths run them (tile 128; K3 unit
#: masses and fast rsqrt, K2 and B16 without split_w, B6's bf16 class with
#: masses as config3_mxu_drift runs it): their occupancy query, its
#: arguments and a part of the kernel's mangled name in nvcc's ptxas
#: report.
BODIES = {
    "K3": ("symmetric_force_info",
           (3, sm.DEFAULT_TILE, int(fast_rsqrt_cube(SOFTENING))),
           "symmetric_force_kernelILi128ELi3ELb1E"),
    "K2": ("slot_pipe_info", (sm.DEFAULT_TILE, 0),
           "slot_pipe_kernelILi128ELb0E"),
    "B6": ("mxu_force_info", (1, 1), "mxu_bf16_kernelILb1E"),
    "B16": ("band_mxu_info",
            (sm.DEFAULT_TILE, 0, int(fast_rsqrt_cube(SOFTENING))),
            "band_mxu_kernelILi128ELb0ELb1E"),
    # The ordered VJPs with masses as autodiff called them beyond
    # _SYM_BWD_MAX, B14 at the rectangular tile, B10 at SimConfig.tile_i;
    # B12 at its tile.
    "B14": ("vjp_rect_mxu_info", (vm.RECT_TILE, 1),
            "vjp_rect_mxu_kernelILi128ELi4E"),
    "B10": ("vjp_ordered_info", (SimConfig(n=N_CONFIG3).tile_i, 1),
            "vjp_ordered_kernelILi4ELb1E"),
    "B12": ("vjp_pair_info", (1,),
            f"vjp_pair_kernelILi{vk.PAIR_TILE}ELi4E"),
    # The pair-once VJPs with masses, without the mass cotangent, at their
    # modules' tiles (--bwd-tile sets both): B11 and B9c, B13 and B9d.
    "B11": lambda: ("vjp_sym_info", (vk.DEFAULT_TILE, 1, 3),
                    f"vjp_sym_kernelILi{vk.DEFAULT_TILE}ELi4ELi3E"),
    "B13": lambda: ("vjp_mxu_info", (vm.DEFAULT_TILE, 1, 8),
                    f"vjp_mxu_kernelILi{vm.DEFAULT_TILE}ELi4ELi8E"),
}


def schedule_info(kernel, n, block, masses, softening):
    """body_info of K1 or K5 at n rows and ``block``, or of K4 at n rows
    (block None: it picks its own rows a CTA), as their wrappers launch
    them, with its rows a thread (R) and rows a CTA."""
    if kernel == "K4":
        r, rows = pk.schedule(n)
        normal = int(df.rsqrt_form(softening, cube=False) == df.FORM_NORMAL)
        body = ("pe_rows_info", (r, rows, normal),
                f"pe_rows_kernelILi{r}ELb{normal}E")
    else:
        r, rows = df.row_schedule(n, block)
        form, euler = df.rsqrt_form(softening), int(kernel == "K5")
        body = ("direct_force_info", (r, rows, int(masses), form, euler),
                f"direct_force_kernelILi{r}ELb{int(masses)}ELi{form}"
                f"ELb{euler}E")
    return {"r": r, "rows_per_cta": rows, **body_info(kernel, body)}


def body_info(kernel, body=None):
    """Registers and local bytes per thread and CTAs per SM of a register
    body (the kernel's own occupancy query; ``body`` an entry as BODIES'
    where the kernel has none there), and its spill bytes from nvcc's
    ptxas report (None when the library was built before this run)."""
    lib = _build.load_library()
    body = BODIES[kernel] if body is None else body
    fn, args, mangled = body() if callable(body) else body
    out = (ctypes.c_int * 4)()  # the VJPs' add threads
    _build.check(lib, getattr(lib, fn)(*args, ctypes.addressof(out)), fn)
    spills = next((v for k, v in _build.ptxas_report(_build.BUILD_LOG)
                   .items() if mangled in k), {})
    return {"registers": out[0], "local_bytes": out[1],
            "ctas_per_sm": out[2],
            "spill_stores": spills.get("spill_stores"),
            "spill_loads": spills.get("spill_loads")}


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

    # Duplicate bodies under coincident='auto', K2's gate at 0 so that the
    # duplicate scan runs: the scan must route to the masked kernel, and a
    # cloud of 8192 copies of one point has exactly zero force.
    nd = 8192
    dup = torch.full((nd, 3), 0.25, device=DEV)
    if not sm.any_coincident(dup):
        fail("any_coincident missed exact duplicates")
    with gate_at(0, "K2"):
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
    with gate_at(0, "K2"):
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
    """One K3 call, or its plain version, on packed bodies p: the self
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
    """One tri and one cross call of K3 on packed p, each held against
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

    tri, cross = pass_launches(N_MAIN, sm.DEFAULT_TILE, 2)
    expect_counts(launches, "main_path", direct=1, slot_tri=tri,
                  slot_cross=cross)
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
    return (state, launches, k1_err, cfg_sym, cfg_dir,
            (idx, oracle, dir_stats, t_sym))


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
    idx, oracle, dir_stats, _ = check
    cfg = SimConfig(n=N_MAIN, steps=1)
    reset_counts()
    step_s, out = host_time(simulate, cfg, state)
    launches = read_counts()
    tri, cross = pass_launches(N_MAIN, sf.DEFAULT_TILE)
    expect_counts(launches, "auto_main_path", sym_tri=tri, sym_cross=cross)
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
    tri, cross = pass_launches(N_CONFIG3, sf.DEFAULT_TILE, STEPS_CONFIG3 + 1)
    expect_counts(launches, "config3_drift", sym_tri=tri, sym_cross=cross,
                  pe=2)
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


#: Slots per piece of the deterministic reduction (slot_pipe.PIECE_SLOTS)
#: at which the timing phases also time one cross call: the partials of
#: the smaller pieces fit in the 50 MB L2 cache.
PIECE_SWEEP = (1 << 13, 1 << 14, 1 << 15, 1 << 16)


def piece_sweep(fn, *args):
    """Milliseconds of fn(*args) at each PIECE_SWEEP value."""
    out = {}
    for piece in PIECE_SWEEP:
        keep, sp.PIECE_SLOTS = sp.PIECE_SLOTS, piece
        try:
            out[piece] = time_fn(fn, *args, reps=3) * 1e3
        finally:
            sp.PIECE_SLOTS = keep
    return out


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
    k1_body = schedule_info("K1", N_MAIN, cfg_dir.tile_i, False,
                            cfg_dir.softening)
    line("time_direct", n=N_MAIN, kernel_ms=k1_s * 1e3,
         kernel_ginter_s=gips(N_MAIN, k1_s),
         kernel_gflops_20=gips(N_MAIN, k1_s) * FLOPS_PER_INTERACTION,
         plain_n=plain_n, plain_ms=plain_s * 1e3,
         plain_ginter_s=gips(plain_n, plain_s), body=k1_body)

    # One tri call (chunk 0) and one cross call (chunks 0, 1) at the
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
    body = body_info("K2")
    line("time_sym_mxu", n=N_MAIN, chunk=c, tile=tile, body=body,
         tri_call_ms=tri_s * 1e3, tri_plain_ms=tri_plain_s * 1e3,
         cross_call_ms=cross_s * 1e3, cross_plain_ms=cross_plain_s * 1e3,
         cross_call_ms_by_piece=piece_sweep(cross, p[a], p[b], v[a], v[b]),
         pass_ms=pass_s * 1e3, pass_ginter_s=gips(N_MAIN, pass_s),
         plain_pass_ms_from_launches=(nc * tri_plain_s + nc * (nc - 1) // 2
                                      * cross_plain_s) * 1e3)
    n = float(N_MAIN)
    tri_pairs, cross_pairs = c * (c - 1) / 2, float(c) * c
    k2_bytes = (2 * c * 3 + 2 * c * 8 + 2 * c * 8) * 4.0  # pos, v in; acc out
    nb = c // tile
    red = {"tri": reduce_ms(sp.slot_table(nb, True, False, DEV), True, tile,
                            8, c),
           "cross": reduce_ms(sp.slot_table(nb, False, True, DEV), False,
                              tile, 8, c)}
    return [
        entry("direct_force (K1)", "direct_force.cu", "pallas_force.py:44",
              launches["direct"], k1_err, k1_s * 1e3, plain_s * 1e3,
              bound(n * (n - 1) * OPS_ORDERED, n * 6 * 4), n=N_MAIN,
              plain_n=plain_n, body=k1_body),
        slot_entry("slot_pipe tri mode (K2)", "slot_pipe.cu",
                   "slot_pipe.py:165", launches["slot_tri"], tri_err,
                   tri_s * 1e3, red["tri"], per_call(tri_slots(c, tile)),
                   tri_plain_s * 1e3,
                   bound(tri_pairs * OPS_K2_FP32, k2_bytes / 2,
                         tri_pairs * OPS_K2_MMA, tri_pairs), chunk=c,
                   body=body),
        slot_entry("slot_pipe cross mode (K2)", "slot_pipe.cu",
                   "slot_pipe.py:210", launches["slot_cross"], cross_err,
                   cross_s * 1e3, red["cross"], per_call(nb * nb),
                   cross_plain_s * 1e3,
                   bound(cross_pairs * OPS_K2_FP32, k2_bytes,
                         cross_pairs * OPS_K2_MMA, cross_pairs), chunk=c,
                   body=body),
    ]


def time_k3(state, launches, cfg_auto):
    """One K3 tri call (chunk 0, fold) and one cross call (chunks 0, 1)
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
    body = body_info("K3")
    line("time_sym", n=N_MAIN, chunk=c, tile=tile,
         tri_call_ms=tri_s * 1e3, tri_plain_ms=tri_plain_s * 1e3,
         cross_call_ms=cross_s * 1e3, cross_plain_ms=cross_plain_s * 1e3,
         cross_call_ms_by_piece=piece_sweep(k3_sums, p, c, tile, soft,
                                              slots["cross"], True),
         pass_ms=pass_s * 1e3, pass_ginter_s=gips(N_MAIN, pass_s),
         pass_bound_ms=bound(N_MAIN * (N_MAIN - 1) / 2 * OPS_PAIR_ONCE,
                             N_MAIN * 6 * 4.0,
                             rsqrts=N_MAIN * (N_MAIN - 1) / 2)["bound_ms"],
         body=body,
         plain_pass_ms_from_launches=(nc * tri_plain_s + nc * (nc - 1) // 2
                                      * cross_plain_s) * 1e3)
    tri_pairs, cross_pairs = c * (c - 1) / 2, float(c) * c
    nb = c // tile
    red = {mode: reduce_ms(t, mode == "tri", tile, 3, c)
           for mode, t in slots.items()}
    return [
        slot_entry("symmetric_force tri mode (K3)", "symmetric_force.cu",
                   "symmetric_force.py:107", launches["sym_tri"], tri_err,
                   tri_s * 1e3, red["tri"], per_call(tri_slots(c, tile)),
                   tri_plain_s * 1e3,
                   bound(tri_pairs * OPS_PAIR_ONCE, c * 6 * 4.0,
                         rsqrts=tri_pairs), chunk=c, body=body),
        slot_entry("symmetric_force cross mode (K3)", "symmetric_force.cu",
                   "symmetric_force.py:155", launches["sym_cross"],
                   cross_err, cross_s * 1e3, red["cross"], per_call(nb * nb),
                   cross_plain_s * 1e3,
                   bound(cross_pairs * OPS_PAIR_ONCE, c * 12 * 4.0,
                         rsqrts=cross_pairs), chunk=c, body=body),
        time_reduce(launches["slot_reduce"], c, tile),
    ]


def time_reduce(launches, c, tile):
    """slot_reduce on one piece of K3's cross list at the auto path's chunk
    (PIECE_SLOTS slots, random partials) against its plain version (the
    same adds in the same order, one target at a time: bitwise) and
    index_add_ of the tiles into their targets; returns its record."""
    nb, width = c // tile, 3
    slots = sp.slot_table(nb, False, True, DEV)
    piece_plan = sp.reduce_plan(slots, False)[0]
    n, targets, offsets, entries = piece_plan[1:5]
    part = torch.randn(n * 2 * tile * width, device=DEV)
    accs = [[torch.zeros((c, width), device=DEV) for _ in range(2)]
            for _ in range(2)]
    sp.slot_reduce_(part, piece_plan, *accs[0], tile, width)
    plain_s, _ = host_time(sp.slot_reduce_plain, part, piece_plan, *accs[1],
                           tile, width)
    err = max((a - b).abs().max().item() for a, b in zip(*accs))
    if err != 0.0:
        fail(f"slot_reduce is not bitwise its plain version: {err}")
    acc = torch.zeros((2 * nb, tile * width), device=DEV)
    per_tile = torch.empty(2 * n, dtype=torch.long, device=DEV)
    per_tile[entries.long()] = torch.repeat_interleave(
        targets.long(), (offsets[1:] - offsets[:-1]).long())
    tiles = part.view(2 * n, tile * width)
    ms = time_fn(sp.slot_reduce_, part, piece_plan, *accs[0], tile, width,
                 reps=3) * 1e3
    library_ms = time_fn(acc.index_add_, 0, per_tile, tiles, reps=3) * 1e3
    nbytes = (part.numel() + 2 * targets.shape[0] * tile * width) * 4.0
    rec = entry("slot_reduce (slot order sums of K2, K3, B11, B13, B9a, "
                "B9b)", "slot_reduce.cu", "symmetric_force.py:155",
                launches, err, ms, plain_s * 1e3,
                bound(part.numel(), nbytes), chunk=c, slots=n,
                targets=targets.shape[0])
    rec["library_ms"] = library_ms
    return rec


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
    body = schedule_info("K4", N_CONFIG3, None, True, soft)
    line("time_pe", n=N_CONFIG3, kernel_ms=k4_s * 1e3, plain_ms=plain_s * 1e3,
         n_main=N_MAIN, kernel_main_ms=main_s * 1e3,
         bound_main_ms=bound(nm * (nm - 1) * OPS_PE, nm * 20.0,
                             rsqrts=nm * (nm - 1))["bound_ms"], body=body)
    return [entry("pe_kernel (K4)", "pe_kernel.cu", "pe_kernel.py:31",
                  launches["pe"], err, k4_s * 1e3, plain_s * 1e3,
                  bound(n * (n - 1) * OPS_PE, n * 20.0,
                        rsqrts=n * (n - 1)), n=N_CONFIG3, body=body)]


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
    body = schedule_info("K5", N_CONFIG2, block, False, args[4])
    line("time_fused_euler", n=N_CONFIG2, block=block, kernel_ms=k5_s * 1e3,
         plain_ms=plain_s * 1e3, max_abs_err=err, body=body)
    return [entry("direct_force fused Euler (K5)", "direct_force.cu",
                  "pallas_force.py:92", launches["fused_euler"], err,
                  k5_s * 1e3, plain_s * 1e3,
                  bound(n * (n - 1) * OPS_ORDERED + n * OPS_EULER,
                        n * 12 * 4.0), n=N_CONFIG2, body=body)]



@contextlib.contextmanager
def plain_versions():
    """While the block runs, every kernel wrapper takes its plain PyTorch
    version, on the card's tensors (each wrapper asks _build.on_card)."""
    on_card = _build.on_card
    _build.on_card = lambda device: False
    try:
        yield
    finally:
        _build.on_card = on_card


#: The coincident gate of each kernel behind one: (module, attribute).
GATES = {"K2": (sm, "COINCIDENT_AUTO_MIN_N"),
         "B16": (sm, "BAND_COINCIDENT_AUTO_MIN_N"),
         "B6": (mf, "COINCIDENT_AUTO_MIN_N"),
         "B10": (vk, "COINCIDENT_AUTO_MIN_N"),
         "B11": (vk, "SYM_COINCIDENT_AUTO_MIN_N"),
         "B13": (vm, "SYM_COINCIDENT_AUTO_MIN_N"),
         "B14": (vm, "COINCIDENT_AUTO_MIN_N")}


@contextlib.contextmanager
def gate_at(n, *kernels):
    """While the block runs, the coincident gate of each kernel named (of
    every kernel when none is) is n: from n bodies on, 'auto' runs the
    duplicate scan and routes by it."""
    saved = [(GATES[k], getattr(*GATES[k])) for k in kernels or GATES]
    for (mod, attr), _ in saved:
        setattr(mod, attr, n)
    try:
        yield
    finally:
        for (mod, attr), gate in saved:
            setattr(mod, attr, gate)


def scale_err(got, want):
    """max |got - want| over max |want|: an error relative to the scale."""
    want = want.double()
    return ((got.double() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def to_dev(a):
    return None if a is None else torch.from_numpy(a).to(DEV)


def normal(rng, n):
    """An (n, 3) cotangent on the card, drawn from rng."""
    return to_dev(rng.normal(size=(n, 3)).astype(np.float32))


#: (n, masses, softening, coincident mode) of vjp_vs_plain: ragged N, unit
#: and mass mode, and softening 1e-9 with two distinct coincident bodies,
#: where only the masked walk is right. vjp_vs_plain and b6_vs_plain set
#: every coincident gate to 0, so 'auto' runs the duplicate scan, which
#: must find the pair.
VJP_CASES = [(3001, False, 1e-2, "auto"), (3001, True, 1e-2, "fast"),
             (3001, False, 1e-9, "masked"), (9001, True, 1e-9, "auto")]


def mxu_sums(p, gp, q, slots, tile, ko, soft, mask, plain=False, cross=None):
    """B13's raw sums of one self chunk (or, with cross = (c, last), of the
    chunk pair (0, last)) from the kernel, or from the bf16-mode plain
    version; rows then reactions in cross mode."""
    if cross is None:
        parts = [(p, gp, q)] * 2
    else:
        c, last = cross
        parts = [(t[:c] for t in (p, gp, q)), (t[last] for t in (p, gp, q))]
        parts = [tuple(x) for x in parts]
    (pa, ga, qa), (pb, gb, qb) = parts
    acc_a = torch.zeros((pa.shape[0], ko), device=DEV)
    acc_b = acc_a if cross is None else torch.zeros((pb.shape[0], ko),
                                                    device=DEV)
    if plain:
        vm.vjp_mxu_sums_plain(acc_a, acc_b, pa, pb, ga, gb, qa, qb, slots,
                              tile, soft, mask, mma_dtype=torch.bfloat16)
    else:
        vm.vjp_mxu_sums_(acc_a, acc_b, pa, pb, ga, gb, qa, qb, slots, tile,
                         soft, mask)
    return acc_a if cross is None else (acc_a, acc_b)


def b13_sums_check(pos, g, m, mass_grad, soft, mask, chunk, what):
    """B13's raw sums against the bf16-mode plain sums per column: the last
    (ragged) self chunk and the chunk pair (0, last)."""
    n = pos.shape[0]
    (tile, c, nc, _), (p, gp, q) = vm.sums_inputs(pos, g, m, chunk=chunk)
    ko = 9 if mass_grad else 8
    last = slice((nc - 1) * c, nc * c)
    real = n - (nc - 1) * c
    nb = c // tile
    args = (tile, ko, soft, mask)
    errs = []
    tri = sp.slot_table(nb, True, False, DEV)
    got, want = (mxu_sums(p[last], gp[last], q[last], tri, *args, plain=pl)
                 for pl in (False, True))
    errs.append(close_cols(got[:real], want[:real], K2_ATOL,
                           f"B13 tri {what}"))
    if nc > 1:
        cross = sp.slot_table(nb, False, True, DEV)
        got, want = (mxu_sums(p, gp, q, cross, *args, plain=pl,
                              cross=(c, last)) for pl in (False, True))
        errs.append(close_cols(got[0], want[0], K2_ATOL,
                               f"B13 cross rows {what}"))
        errs.append(close_cols(got[1][:real], want[1][:real], K2_ATOL,
                               f"B13 cross reactions {what}"))
    return max(errs)


def vjp_phase(rng):
    """B10, B11, B13 and B14 against their plain versions on the same card
    tensors (VJP_CASES; chunk 1024, so B11 and B13 run tri and cross
    launches): B10 and B11 at K1's bound, with B11's mass cotangent in mass
    mode; B13's and B14's raw sums against their bf16-mode plain sums per
    column at K2's bound; and B13's and B14's gradients against the fp32
    B11 at the sym_mxu bound."""
    errs = {"B10": [], "B11": [], "B13": [], "B14": []}
    bf16_vs_fp32 = []
    # Every gate at 0: 'auto' runs the duplicate scan at every N.
    with gate_at(0):
        for n, masses, soft, mode in VJP_CASES:
            pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
            if soft < 1e-6:
                pos[n - 7] = pos[3]  # two distinct bodies at one point
            pos = to_dev(pos)
            g = normal(rng, n)
            m = to_dev(rng.uniform(0.5, 2.0, n).astype(np.float32)
                       if masses else None)
            what = f"n={n} masses={masses} softening={soft} {mode}"
            # B10: the square call, and a rectangle of receivers.
            got = vk.vjp_pos_direct(pos, g, m, soft, coincident=mode)
            want = vk.vjp_ordered_plain(pos, g, pos, g, m, m, soft)
            errs["B10"].append(close_grad(got, want, K1_RTOL, K1_ATOL,
                                          f"B10 {what}"))
            k = slice(0, 1000)
            rect = vk.vjp_pos_rect(pos[k].contiguous(), g[k].contiguous(), pos,
                                   g, None if m is None else m[k].contiguous(),
                                   m, soft)
            errs["B10"].append(close_grad(rect, want[k], K1_RTOL, K1_ATOL,
                                          f"B10 rect {what}"))
            # B11 over three chunks, with the mass cotangent in mass mode.
            kw = dict(chunk=1024, mass_grad=masses, coincident=mode)
            got = vk.vjp_pos_sym(pos, g, m, soft, **kw)
            with plain_versions():
                want = vk.vjp_pos_sym(pos, g, m, soft, **kw)
            got, want = (o if masses else (o,) for o in (got, want))
            for a, b, part in zip(got, want, ("pos_bar", "mass_bar")):
                errs["B11"].append(close_grad(a, b, K1_RTOL, K1_ATOL,
                                              f"B11 {part} {what}"))
            fp32 = got
            # B13: raw sums per column, then the gradient against fp32 B11.
            mask = mode == "masked"
            if mode == "auto":
                mask = sm.any_coincident(pos)
                if soft < 1e-6 and not mask:
                    fail(f"any_coincident missed the coincident pair, {what}")
            errs["B13"].append(b13_sums_check(pos, g, m, masses, soft, mask,
                                              1024, what))
            got = vm.vjp_pos_sym_mxu(pos, g, m, soft, **kw)
            got = got if masses else (got,)
            close_grad(got[0], fp32[0], SYM_RTOL, SYM_ATOL,
                       f"B13 vs B11 {what}")
            bf16_vs_fp32.append(scale_err(got[0], fp32[0]))
            if masses:  # the mass column is summed in fp32
                close_grad(got[1], fp32[1], K1_RTOL, K1_ATOL,
                           f"B13 mass_bar {what}")
            # B14 square: raw rows per column, then the gradient vs fp32 B11.
            rows = vm.vjp_rect_mxu_rows(pos, g, pos, g, m, m, soft,
                                        square_coincident=mode)
            want = vm.vjp_rect_mxu_plain(pos, g, pos, g, m, m, soft,
                                         mma_dtype=torch.bfloat16)
            errs["B14"].append(close_cols(rows, want, K2_ATOL, f"B14 {what}"))
            got = vm.vjp_rect_mxu(pos, g, pos, g, m, m, soft, coincident=mode)
            close_grad(got, fp32[0], SYM_RTOL, SYM_ATOL, f"B14 vs B11 {what}")
            bf16_vs_fp32.append(scale_err(got, fp32[0]))
    torch.cuda.synchronize()
    line("vjp_vs_plain", cases=len(VJP_CASES),
         max_abs_err={k: max(v) for k, v in errs.items()},
         bf16_class_vs_fp32_max_err_of_scale=max(bf16_vs_fp32))
    return {k: max(v) for k, v in errs.items()}


def sqrt_passes(steps):
    """Force passes of a "sqrt" rollout of ``steps`` steps and its backward:
    every step once forward, and every step inside a checkpointed segment
    once more in the backward (sim.make_rollout_fn)."""
    if steps <= 2:
        return steps
    inner = math.isqrt(steps)
    return steps + steps // inner * inner


def rollout_grad(cfg, carry0, on="pos", remat="sqrt"):
    """sum(pos_final^2) (on="pos") or sum(vel_final^2) (on="vel") of a
    GRAD_STEPS-step rollout (checkpointed by ``remat``) from carry0, and its
    gradient in the initial positions; the initial acceleration is held
    constant, as tests/test_sim.py:190-207 does."""
    state, acc = carry0
    p = state.pos.clone().requires_grad_(True)
    out, _ = make_rollout_fn(cfg, GRAD_STEPS, remat)(
        (BodyState(pos=p, vel=state.vel, mass=state.mass), acc))
    loss = ((out.pos if on == "pos" else out.vel) ** 2).sum()
    loss.backward()
    torch.cuda.synchronize()
    if p.grad.shape != p.shape or not torch.isfinite(p.grad).all():
        fail(f"rollout gradient at n={p.shape[0]}: non-finite or misshapen")
    return loss.item(), p.grad


def counted_grad(cfg, carry0, on, path, **want):
    """rollout_grad with every launch count set to 0 just before it, held
    to the launches ``want`` plus the path's backward; returns (seconds,
    loss, gradient, launches)."""
    reset_counts()
    seconds, (loss, grad) = host_time(rollout_grad, cfg, carry0, on)
    launches = read_counts()
    expect_counts(launches, f"{path} (loss on {on})", **want)
    return seconds, loss, grad, launches


def grad_cfg(n, backend="auto", dt=1e-3):
    """BASELINE config 3's physics: plummer with masses, leapfrog,
    softening 1e-2, dt 1e-3."""
    return SimConfig(n=n, dt=dt, softening=1e-2, integrator="leapfrog",
                     use_masses=True, backend=backend)


def adam_phase(state):
    """examples/optimize_impact.py's loss on config 3's cluster: body 0 is
    a probe at `start` whose initial velocity is optimised so that it ends
    at `target` after ADAM_STEPS leapfrog steps of ADAM_DT, through a
    "sqrt" rollout. Adam's step is a fifth of the first miss per unit of
    time, so one step moves the probe's end by about a fifth of the miss
    (the example's fixed 0.5 fits its 40 steps at N = 512). The loss must
    fall."""
    cfg = grad_cfg(state.n, dt=ADAM_DT)
    start = torch.tensor([-1.5, -1.0, 0.0], device=DEV)
    target = torch.tensor([1.2, 0.8, 0.0], device=DEV)
    pos = state.pos.clone()
    pos[0] = start
    span = ADAM_STEPS * ADAM_DT
    v0 = ((target - start) / span).requires_grad_(True)
    acc0 = init_carry(cfg, BodyState(pos=pos, vel=state.vel,
                                     mass=state.mass))[1]
    rollout = make_rollout_fn(cfg, ADAM_STEPS)

    def miss2():
        vel = torch.cat([v0[None], state.vel[1:]])
        out, _ = rollout((BodyState(pos=pos, vel=vel, mass=state.mass),
                          acc0))
        return ((out.pos[0] - target) ** 2).sum()

    losses, opt = [], None
    t0 = time.perf_counter()
    for _ in range(ADAM_ITERS):
        loss = miss2()
        if opt is None:
            opt = torch.optim.Adam([v0], lr=0.2 * loss.item() ** 0.5 / span)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    with torch.no_grad():
        losses.append(miss2().item())
    seconds = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < \
            losses[0]:
        fail(f"Adam did not lower the probe loss: {losses}")
    return {"iters": ADAM_ITERS, "steps": ADAM_STEPS, "dt": ADAM_DT,
            "lr": opt.param_groups[0]["lr"], "miss2": losses,
            "seconds": seconds}


def grad_config3_phase(rng):
    """The differentiable path at config 3's N = 262,144 on 'auto': a
    GRAD_STEPS-step "sqrt" rollout gradient, forward K3 and backward B11
    (the card's route at every N, beyond JAX's autodiff._SYM_BWD_MAX),
    exact launch counts; one B11 call as the route makes it (two chunks,
    tri and cross launches) and one B10 call, B10 kept on the card though
    autodiff no longer routes a CUDA tensor to it, each held against the
    same plain VJP, B10 timed; then the Adam run. Returns the state, the
    gradient and B10's record."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    state = init.plummer(N_CONFIG3, generator=gen, device=DEV)
    cfg = grad_cfg(N_CONFIG3)
    carry0 = init_carry(cfg, state)
    first_s, _ = host_time(rollout_grad, cfg, carry0)
    tri, cross = pass_launches(N_CONFIG3, sf.DEFAULT_TILE,
                               sqrt_passes(GRAD_STEPS))
    runs = {}
    for on in ("pos", "vel"):
        b11_tri, b11_cross = pass_launches(N_CONFIG3, vk.DEFAULT_TILE,
                                           GRAD_VJPS[on])
        runs[on] = counted_grad(cfg, carry0, on, "grad_config3",
                                sym_tri=tri, sym_cross=cross,
                                vjp_sym_tri=b11_tri, vjp_sym_cross=b11_cross)
    seconds, loss, _, launches = runs["pos"]
    # One B10 call as autodiff made it beyond _SYM_BWD_MAX ('auto' on
    # duplicate-free bodies is 'fast' after the scan: tiles off the
    # diagonal drop the mask).
    g = normal(rng, N_CONFIG3)
    args = (state.pos, g, state.mass, cfg.softening, cfg.tile_i, "fast")
    reset_counts()
    got = vk.vjp_pos_direct(*args)
    b10_launches = read_counts()["vjp_ordered"]
    plain_s, want = host_time(vk.vjp_ordered_plain, state.pos, g, state.pos,
                              g, state.mass, state.mass, cfg.softening)
    err = close_grad(got, want, K1_RTOL, K1_ATOL, f"B10 at N={N_CONFIG3}")
    b11_err = close_grad(vk.vjp_pos_sym(state.pos, g, state.mass,
                                        cfg.softening),
                         want, K1_RTOL, K1_ATOL, f"B11 at N={N_CONFIG3}")
    b10_s = time_fn(vk.vjp_pos_direct, *args, reps=3)
    adam = adam_phase(state)
    line("grad_config3", n=N_CONFIG3, steps=GRAD_STEPS, remat="sqrt",
         loss_pos=loss, first_seconds=first_s, seconds=seconds,
         launches=launches, seconds_vel=runs["vel"][0],
         launches_vel=runs["vel"][3], b10_vs_plain_max_abs_err=err,
         b11_vs_plain_max_abs_err=b11_err, adam=adam)
    n = float(N_CONFIG3)
    record = entry("vjp_kernel ordered (B10)", "vjp_kernel.cu",
                   "vjp_kernel.py:106", b10_launches, err,
                   b10_s * 1e3, plain_s * 1e3,
                   bound(n * (n - 1) * OPS_B10, n * 40.0), n=N_CONFIG3,
                   block=cfg.tile_i, body=body_info("B10"))
    return state, runs["vel"][2], record


def grad_sym_phase(rng):
    """The rollout gradient (loss on the final velocities) at N_GRAD_SYM on
    'auto' (backward B11) against the same rollout with every kernel
    swapped for its plain version on the card, at K1's bound; B11's mass
    cotangent
    (make_differentiable_force(cfg, mass_grad=True)) against the plain
    version's; and B11 timed as the path calls it."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    state = init.plummer(N_GRAD_SYM, generator=gen, device=DEV)
    cfg = grad_cfg(N_GRAD_SYM)
    carry0 = init_carry(cfg, state)
    k3_tri = pass_launches(N_GRAD_SYM, sf.DEFAULT_TILE)[0]
    b11_tri = pass_launches(N_GRAD_SYM, vk.DEFAULT_TILE)[0]
    seconds, loss, grad, launches = counted_grad(
        cfg, carry0, "vel", "grad_sym",
        sym_tri=k3_tri * sqrt_passes(GRAD_STEPS),
        vjp_sym_tri=b11_tri * GRAD_VJPS["vel"])
    with plain_versions():
        plain_seconds, (_, plain_grad) = host_time(rollout_grad, cfg, carry0,
                                                   "vel")
    grad_err = close_grad(grad, plain_grad, K1_RTOL, K1_ATOL,
                          "grad_sym rollout vs plain")
    g = normal(rng, N_GRAD_SYM)
    diff_force = make_differentiable_force(cfg, mass_grad=True)

    def bars():
        p = state.pos.clone().requires_grad_(True)
        m = state.mass.clone().requires_grad_(True)
        diff_force(p, m).backward(g)
        return p.grad, m.grad

    reset_counts()
    got = bars()
    expect_counts(read_counts(), "grad_sym mass_grad", sym_tri=k3_tri,
                  vjp_sym_tri=b11_tri)
    with plain_versions():
        want = bars()
    mass_err = [close_grad(a, b, K1_RTOL, K1_ATOL,
                           f"B11 mass_grad {what}")
                for a, b, what in zip(got, want, ("pos_bar", "mass_bar"))]
    mass_scale = want[1].abs().max().item()
    args = (state.pos, g, state.mass, cfg.softening, vk.DEFAULT_TILE, CHUNK,
            False, "fast")
    b11_s = time_fn(vk.vjp_pos_sym, *args, reps=3)
    got = vk.vjp_pos_sym(*args)
    with plain_versions():
        plain_s, want = host_time(vk.vjp_pos_sym, *args)
    err = close_grad(got, want, K1_RTOL, K1_ATOL, f"B11 at N={N_GRAD_SYM}")
    line("grad_sym", n=N_GRAD_SYM, steps=GRAD_STEPS, remat="sqrt",
         loss_vel=loss, seconds=seconds, plain_seconds=plain_seconds,
         launches=launches, grad_vs_plain_max_abs_err=grad_err,
         grad_max_abs=plain_grad.abs().max().item(),
         grad_vs_plain_max_err_of_scale=scale_err(grad, plain_grad),
         mass_grad_vs_plain_max_abs_err=mass_err,
         mass_bar_max_abs=mass_scale)
    n = float(N_GRAD_SYM)
    tile = vk.DEFAULT_TILE
    red = reduce_ms(sp.slot_table(N_GRAD_SYM // tile, True, False, DEV),
                    True, tile, 3, N_GRAD_SYM)
    record = slot_entry("vjp_kernel pair-once (B11)", "vjp_kernel.cu",
                        "vjp_kernel.py:273",
                        launches["vjp_sym_tri"] + launches["vjp_sym_cross"],
                        err, b11_s * 1e3, red, b11_tri, plain_s * 1e3,
                        bound(n * (n - 1) / 2 * OPS_B11, n * 40.0),
                        n=N_GRAD_SYM, tile=tile, body=body_info("B11"))
    return state, grad, record


def grad_sym_mxu_phase(rng, sym, config3):
    """The rollout gradient (loss on the final velocities) on sym_mxu at
    N_GRAD_SYM and at config 3's N (backward B13 at both, the card's route
    at every N, beyond JAX's autodiff._SYM_BWD_MAX), each against the fp32
    gradient of the same state at the bf16-class bound; then one B13 call
    at N_GRAD_SYM, B13's raw sums at config 3's N as the route makes them
    (masked: the last self chunk and the chunk pair (0, last)), and one B14
    launch at config 3's N, B14 kept on the card though autodiff no longer
    routes a CUDA tensor to it, held per column against their bf16-mode
    plain sums; the single launches timed."""
    out, records = {}, []
    for (state, fp32), kernel in ((sym, "B13"), (config3, "B14")):
        n = state.n
        cfg = grad_cfg(n, backend="sym_mxu")
        carry0 = init_carry(cfg, state)
        tri, cross = pass_launches(n, sm.DEFAULT_TILE,
                                   sqrt_passes(GRAD_STEPS))
        b13_tri, b13_cross = pass_launches(n, vm.DEFAULT_TILE,
                                           GRAD_VJPS["vel"])
        seconds, loss, grad, launches = counted_grad(
            cfg, carry0, "vel", f"grad_sym_mxu n={n}", slot_tri=tri,
            slot_cross=cross, vjp_mxu_tri=b13_tri, vjp_mxu_cross=b13_cross)
        close_grad(grad, fp32, SYM_RTOL, SYM_ATOL,
                   f"grad_sym_mxu n={n} vs fp32")
        out[n] = {"seconds": seconds, "loss_vel": loss, "launches": launches,
                  "fp32_grad_max_abs": fp32.abs().max().item(),
                  "vs_fp32_max_err_of_scale": scale_err(grad, fp32),
                  "vs_fp32": rel_err_stats(grad, fp32)}
        g = normal(rng, n)
        if kernel == "B13":  # the one tri call of the path
            per = pass_launches(n, vm.DEFAULT_TILE)[0]
            (tile, c, _, _), (p, gp, q) = vm.sums_inputs(
                state.pos, g, state.mass, chunk=CHUNK)
            slots = sp.slot_table(c // tile, True, False, DEV)
            args = (p, gp, q, slots, tile, 8, cfg.softening, False)
            ms = time_fn(mxu_sums, *args, reps=3) * 1e3
            got = mxu_sums(*args)
            plain_s, want = host_time(mxu_sums, *args, True)
            err = close_cols(got, want, K2_ATOL, f"B13 at N={n}")
            pairs = n * (n - 1) / 2
            red = reduce_ms(slots, True, tile, 8, c)
            records.append(slot_entry(
                "vjp_mxu pair-once (B13)", "vjp_mxu.cu", "vjp_mxu.py:134",
                launches["vjp_mxu_tri"] + launches["vjp_mxu_cross"], err, ms,
                red, per, plain_s * 1e3,
                bound(pairs * OPS_B13_FP32, n * 40.0, pairs * OPS_B13_MMA),
                n=n, tile=tile, body=body_info("B13")))
        else:  # B13 as the route runs it; B14 called square
            b13_err = b13_sums_check(state.pos, g, state.mass, False,
                                     cfg.softening, True, CHUNK,
                                     f"at N={n}")
            out[n]["b13_raw_sums_max_abs_err"] = b13_err
            args = (state.pos, g, state.pos, g, state.mass, state.mass,
                    cfg.softening)
            ms = time_fn(vm.vjp_rect_mxu_rows, *args, vm.RECT_TILE, "fast",
                         reps=3) * 1e3
            reset_counts()
            got = vm.vjp_rect_mxu_rows(*args, vm.RECT_TILE, "fast")
            b14_launches = read_counts()["vjp_rect_mxu"]
            plain_s, want = host_time(vm.vjp_rect_mxu_plain, *args,
                                      torch.bfloat16)
            err = close_cols(got, want, K2_ATOL, f"B14 at N={n}")
            pairs = float(n) * (n - 1)
            records.append(entry(
                "vjp_mxu rectangular (B14)", "vjp_mxu.cu", "vjp_mxu.py:179",
                b14_launches, err, ms, plain_s * 1e3,
                bound(pairs * OPS_B14_FP32, n * 40.0, pairs * OPS_B14_MMA),
                n=n, tile=vm.RECT_TILE, body=body_info("B14")))
        out[n]["kernel_ms"], out[n]["raw_sums_max_abs_err"] = ms, err
    line("grad_sym_mxu", steps=GRAD_STEPS, remat="sqrt", runs=out)
    return records


def b6_case(rng, n, masses, soft):
    """Bodies for b6_vs_plain: uniform in [-1, 1]^3, two distinct bodies at
    one point when soft < 1e-6 (VJP_CASES' rule)."""
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if soft < 1e-6:
        pos[n - 7] = pos[3]
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return to_dev(pos), to_dev(m)


def b6_sums_check(pi, pj, m, soft, overlap, what):
    """One B6 launch's raw sums against its bf16-mode plain sums at the
    kernel's tiles, per column; returns (max abs error, forces)."""
    f, s = mf.hybrid_forces(pi, pj, m, soft, overlap_only=overlap,
                            with_sums=True)
    want = mf.hybrid_sums_plain(pi, pj, m, soft, mf.KERNEL_TILE,
                                mf.KERNEL_TILE, overlap,
                                mma_dtype=torch.bfloat16)
    return close_cols(s, want, K2_ATOL, f"B6 {what}"), f


def b6_phase(rng):
    """B6 against its plain version on the same card tensors (VJP_CASES:
    ragged N, both mass modes, softening 1e-9 with two coincident bodies):
    square calls in the masking the coincident mode resolves to, and the
    64 x N rectangle, raw sums per column at K2's bound; the fp32 mode
    against the fp64 oracle at K1's bound; and auto and fast bitwise equal
    to masked on a duplicate-free state in both classes."""
    errs, fp32_errs = [], []
    # Every gate at 0: 'auto' runs the duplicate scan at every N.
    with gate_at(0):
        for n, masses, soft, mode in VJP_CASES:
            pos, m = b6_case(rng, n, masses, soft)
            what = f"n={n} masses={masses} softening={soft} {mode}"
            overlap = mf.square_overlap_only(pos, mode)
            if soft < 1e-6 and overlap:
                fail(f"B6 square {what}: the coincident pair took the "
                     "overlap run")
            errs.append(b6_sums_check(pos, pos, m, soft, overlap,
                                      f"square {what}")[0])
            sub = pos[:64].contiguous()
            errs.append(b6_sums_check(sub, pos, m, soft, False,
                                      f"rect 64xN {what}")[0])
            md = None if m is None else m.double()
            for pi in (pos, sub):
                got = mf.body_force_mxu(pi, pos, m, soft, pair_dtype="float32",
                                        coincident=mode)
                oracle = body_force_torch(pi.double(), pos.double(), md,
                                          softening=soft, row_chunk=512)
                fp32_errs.append(close(got, oracle, K1_RTOL, K1_ATOL,
                                       f"B6 fp32 vs fp64 {what} ni={len(pi)}"))
        pos, m = b6_case(rng, 9001, True, 1e-2)
        if sm.any_coincident(pos):
            fail("B6: the duplicate-free state has a duplicate")
        for pair_dtype in ("bfloat16", "float32"):
            ref = mf.body_force_mxu(pos, pos, m, pair_dtype=pair_dtype)
            for mode in ("auto", "fast"):
                got = mf.body_force_mxu(pos, pos, m, pair_dtype=pair_dtype,
                                        coincident=mode)
                if not torch.equal(got, ref):
                    fail(f"B6 {pair_dtype}: {mode} is not bitwise masked")
    torch.cuda.synchronize()
    line("b6_vs_plain", cases=len(errs), max_abs_err=max(errs),
         fp32_vs_fp64_max_abs_err=max(fp32_errs),
         auto_fast_bitwise_masked=True)
    return max(errs)


def b4_sums(pos, m, na, tile, soft, mask, plain=False):
    """One B4 call (K2's cross mode over the rectangle of the sets
    pos[:na] and pos[na:]), or its bf16-mode plain version: the raw sums of
    both sides, each cut to its real rows."""
    nb = pos.shape[0] - na
    ma, mb = (None, None) if m is None else (m[:na], m[na:])
    pa, va = sm._pack(pos[:na], ma, na, sm.round_up(na, tile))
    pb, vb = sm._pack(pos[na:], mb, nb, sm.round_up(nb, tile))
    if plain:
        rows, cols = sp.cross_slot_sums_plain(pa, pb, va, vb, soft, tile,
                                              mask=mask,
                                              mma_dtype=torch.bfloat16)
        return rows.T[:na], cols.T[:nb]
    acc_a = torch.zeros((pa.shape[0], 8), device=DEV)
    acc_b = torch.zeros((pb.shape[0], 8), device=DEV)
    slots = sp.slot_table(pa.shape[0] // tile, False, True, DEV,
                          nb_b=pb.shape[0] // tile)
    sp.pair_slot_sums_(acc_a, acc_b, pa, pb, va, vb, slots, tile, soft,
                       mask=mask)
    return acc_a[:na], acc_b[:nb]


def b4_phase(rng):
    """B4 against its plain version with na != nb (ragged, both mass modes,
    masked and maskless, both of K2's tiles), raw sums per column at K2's
    bound; then body_force_pair_mxu's forces against the fp64 oracle with a
    cross-set coincident pair at softening 1e-9 (masked)."""
    errs = []
    for na, nb, masses in ((700, 2301, False), (3001, 1000, True)):
        pos, m = b6_case(rng, na + nb, masses, 1e-2)
        for tile in sp.KERNEL_TILES:
            for mask in (False, True):
                got = b4_sums(pos, m, na, tile, 1e-2, mask)
                want = b4_sums(pos, m, na, tile, 1e-2, mask, plain=True)
                for g, w, side in zip(got, want, ("rows", "reactions")):
                    errs.append(close_cols(
                        g, w, K2_ATOL, f"B4 {side} na={na} nb={nb} "
                        f"masses={masses} tile={tile} mask={mask}"))
    pos, m = b6_case(rng, 3000, True, 1e-9)  # the pair (3, 2993) is split
    pa, pb = pos[:1500].contiguous(), pos[1500:].contiguous()
    ma, mb = m[:1500].contiguous(), m[1500:].contiguous()
    with gate_at(0, "K2"):  # the scan finds the split pair
        fa, fb = sm.body_force_pair_mxu(pa, pb, ma, mb, 1e-9,
                                        coincident="auto")
    for got, pi, pj, mj, side in ((fa, pa, pb, mb, "a"), (fb, pb, pa, ma, "b")):
        close(got, body_force_torch(pi.double(), pj.double(), mj.double(),
                                    row_chunk=512),
              SYM_RTOL, SYM_ATOL, f"B4 F_on_{side} vs fp64")
    torch.cuda.synchronize()
    line("b4_vs_plain", cases=len(errs), max_abs_err=max(errs))
    return max(errs)


def mxu_main_phase(state, check):
    """simulate, one Euler step at N_MAIN on mxu with bf16 pairs from the
    main path's state: exactly one B6 launch; forces on the main path's
    rows against the fp64 oracle at the sym_mxu bound; ms per pass."""
    idx, oracle, *_ = check
    cfg = SimConfig(n=N_MAIN, steps=1, backend="mxu", pair_dtype="bfloat16")
    route = ("overlap" if mf.square_overlap_only(state.pos, cfg.coincident)
             else "masked")
    reset_counts()
    step_s, out = host_time(simulate, cfg, state)
    launches = read_counts()
    expect_counts(launches, "mxu_main_path", mxu=1)
    for t in (out.pos, out.vel):
        if t.shape != (N_MAIN, 3) or not torch.isfinite(t).all():
            fail("mxu: non-finite or misshapen state")
    force = make_force_fn(cfg)
    f = force(state.pos, state.pos)[idx]
    close(f, oracle, SYM_RTOL, SYM_ATOL, "mxu bf16 vs fp64 oracle")
    pass_s = time_fn(force, state.pos, state.pos, reps=2)
    n = float(N_MAIN)
    line("mxu_main_path", n=N_MAIN, pair_dtype=cfg.pair_dtype,
         coincident_route=route, euler_1_step_s=step_s, launches=launches,
         pass_ms=pass_s * 1e3, pass_ginter_s=gips(N_MAIN, pass_s),
         pass_bound_ms=bound(n * (n - 1) * OPS_B6_FP32, n * 24.0,
                             n * (n - 1) * OPS_B6_MMA,
                             n * (n - 1))["bound_ms"],
         mxu_vs_fp64=rel_err_stats(f, oracle))
    return pass_s


def config3_mxu_phase():
    """BASELINE config 3 as written, in the bf16-pair class: plummer with
    masses, N = 262,144, softening 1e-2, dt 1e-3, 1000 leapfrog steps on
    mxu with pair_dtype "bfloat16" (B6), E0 and E1 through K4; fails above
    the drift gate."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    state = init.plummer(N_CONFIG3, generator=gen, device=DEV)
    cfg = SimConfig(n=N_CONFIG3, steps=STEPS_CONFIG3, dt=1e-3,
                    softening=1e-2, integrator="leapfrog", use_masses=True,
                    backend="mxu", pair_dtype="bfloat16")
    probe_s, _ = host_time(simulate, cfg, state, 1)
    estimate_s = probe_s * (STEPS_CONFIG3 + 1) / 2
    if estimate_s > CONFIG3_MAX_S:
        fail(f"config3_mxu: one step took {probe_s:.3f} s, so "
             f"{STEPS_CONFIG3} steps would take ~{estimate_s:.0f} s")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0 = dg.total_energy(state, cfg.softening)
    out = simulate(cfg, state)
    e1 = dg.total_energy(out, cfg.softening)
    drift = dg.energy_drift(e0, e1).item()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    expect_counts(launches, "config3_mxu_drift", mxu=STEPS_CONFIG3 + 1,
                  pe=2)
    dg.assert_finite(out, "after config 3 on mxu")
    if not drift <= DRIFT_GATE:
        fail(f"config3_mxu: energy drift {drift:.3g} > {DRIFT_GATE}")
    line("config3_mxu_drift", n=N_CONFIG3, steps=STEPS_CONFIG3,
         pair_dtype=cfg.pair_dtype, drift=drift, e0=e0.item(), e1=e1.item(),
         launches=launches, seconds=seconds, one_step_probe_s=probe_s,
         momentum_after=dg.momentum(out).tolist())
    return state, launches


def grad_mxu_phase(sym):
    """The rollout gradient (loss on the final velocities) on mxu with
    bf16 pairs at N_GRAD_SYM: forward B6, backward B13, exact counts;
    against grad_sym's fp32 gradient of the same state at the bf16-class
    bound, relative to the gradient's own scale."""
    state, fp32 = sym
    cfg = grad_cfg(state.n, backend="mxu").replace(pair_dtype="bfloat16")
    carry0 = init_carry(cfg, state)
    seconds, loss, grad, launches = counted_grad(
        cfg, carry0, "vel", "grad_mxu", mxu=sqrt_passes(GRAD_STEPS),
        vjp_mxu_tri=pass_launches(state.n, vm.DEFAULT_TILE)[0]
        * GRAD_VJPS["vel"])
    err = close_grad(grad, fp32, SYM_RTOL, SYM_ATOL, "grad_mxu vs fp32")
    line("grad_mxu", n=state.n, steps=GRAD_STEPS, remat="sqrt",
         loss_vel=loss, seconds=seconds, launches=launches,
         vs_fp32_max_abs_err=err,
         fp32_grad_max_abs=fp32.abs().max().item(),
         vs_fp32_max_err_of_scale=scale_err(grad, fp32),
         vs_fp32=rel_err_stats(grad, fp32))


def pair_mxu_phase(state3):
    """B4 on the two halves of config 3's plummer state (masses): exactly
    one K2 cross call on the rectangle; F_on_a against the B6 rectangle
    a <- b, F_on_b against b <- a, both against the fp64 oracle on 1024
    rows; then one B4 call held per column against its plain version
    and timed."""
    half = N_CONFIG3 // 2
    soft = 1e-2
    pa, pb = state3.pos[:half].contiguous(), state3.pos[half:].contiguous()
    ma, mb = state3.mass[:half].contiguous(), state3.mass[half:].contiguous()
    reset_counts()
    fa, fb = sm.body_force_pair_mxu(pa, pb, ma, mb, soft)
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts(launches, "pair_mxu",
                  pair_mxu=per_call((half // sm.DEFAULT_TILE) ** 2))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    idx = torch.randperm(half, generator=gen, device=DEV)[:1024]
    stats = {}
    for got, pi, pj, mj, side in ((fa, pa, pb, mb, "a"), (fb, pb, pa, ma, "b")):
        rect = mf.body_force_mxu(pi, pj, mj, soft)
        close(got, rect, SYM_RTOL, SYM_ATOL, f"B4 F_on_{side} vs B6")
        oracle = body_force_torch(pi[idx].double(), pj.double(), mj.double(),
                                  softening=soft, row_chunk=16)
        close(got[idx], oracle, SYM_RTOL, SYM_ATOL, f"B4 F_on_{side} vs fp64")
        stats[side] = {"vs_fp64": rel_err_stats(got[idx], oracle),
                       "vs_b6_max_err_of_scale": scale_err(got, rect)}
    pos, m = state3.pos, state3.mass
    tile = sm.DEFAULT_TILE
    ms = time_fn(b4_sums, pos, m, half, tile, soft, True, reps=3) * 1e3
    got = b4_sums(pos, m, half, tile, soft, True)
    plain_s, want = host_time(b4_sums, pos, m, half, tile, soft, True, True)
    err = max(close_cols(g, w, K2_ATOL, f"B4 {side} at {half}x{half}")
              for g, w, side in zip(got, want, ("rows", "reactions")))
    line("pair_mxu", na=half, nb=half, launches=launches, kernel_ms=ms,
         plain_ms=plain_s * 1e3, raw_sums_max_abs_err=err, sides=stats)
    pairs = float(half) * half
    nb = half // tile
    red = reduce_ms(sp.slot_table(nb, False, True, DEV, nb_b=nb), False,
                    tile, 8, half)
    return slot_entry("slot_pipe cross mode on a rectangle (B4)",
                      "slot_pipe.cu", "sym_mxu_force.py:267",
                      launches["pair_mxu"], err, ms, red, per_call(nb * nb),
                      plain_s * 1e3,
                      bound(pairs * OPS_K2_FP32, 2 * half * (3 + 8 + 8) * 4.0,
                            pairs * OPS_K2_MMA, pairs), na=half, nb=half,
                      tile=tile)


def time_b6(state3, c3_launches, main_pass_s):
    """One B6 launch as config3_mxu_drift makes it (N = 262,144, masses,
    the overlap run after the duplicate scan) beside its bf16-mode plain
    version, held per column, and its bound; the N_MAIN pass time and
    bound from mxu_main_path beside them."""
    pos, m, soft = state3.pos, state3.mass, 1e-2
    overlap = mf.square_overlap_only(pos, "auto")
    ms = time_fn(mf.hybrid_forces, pos, pos, m, soft, 512, 2048, overlap,
                 reps=3) * 1e3
    _, got = mf.hybrid_forces(pos, pos, m, soft, overlap_only=overlap,
                              with_sums=True)
    plain_s, want = host_time(mf.hybrid_sums_plain, pos, pos, m, soft,
                              mf.KERNEL_TILE, mf.KERNEL_TILE, overlap,
                              "bfloat16", torch.bfloat16)
    err = close_cols(got, want, K2_ATOL, f"B6 at N={N_CONFIG3}")
    n, nm = float(N_CONFIG3), float(N_MAIN)
    body = body_info("B6")
    line("time_mxu", n=N_CONFIG3, kernel_ms=ms, plain_ms=plain_s * 1e3,
         raw_sums_max_abs_err=err, n_main=N_MAIN,
         main_pass_ms=main_pass_s * 1e3, body=body)
    return entry("mxu_force hybrid (B6)", "mxu_force.cu", "mxu_force.py:98",
                 c3_launches["mxu"], err, ms, plain_s * 1e3,
                 bound(n * (n - 1) * OPS_B6_MASS, n * 28.0,
                       n * (n - 1) * OPS_B6_MMA, n * (n - 1)), n=N_CONFIG3,
                 masses=True, pair_dtype="bfloat16", main_n=N_MAIN,
                 main_ms=main_pass_s * 1e3,
                 main_bound_ms=bound(nm * (nm - 1) * OPS_B6_FP32, nm * 24.0,
                                     nm * (nm - 1) * OPS_B6_MMA,
                                     nm * (nm - 1))["bound_ms"],
                 body=body)


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def determinism_phase(rng):
    """C2: K2, K3, B11, B13, B16, B10 and B14 each run twice at
    N_DETERMINISM (two chunks, so tri and cross launches; B10 and B14 one
    square launch each, as autodiff made them beyond _SYM_BWD_MAX, B10 at
    SimConfig.tile_i) and must
    agree bit for bit; sym_mxu's 'auto' and 'fast' must be bitwise 'masked'
    at N_GRAD_SYM on the slots and on the band, and B10's and B14's 'fast'
    bitwise their 'masked' at N_DETERMINISM on the same duplicate-free
    bodies; and a GRAD_STEPS rollout gradient with remat "sqrt" bitwise the
    one with "none", on 'auto' (K3, B11) and 'sym_mxu' (K2, B13) at
    N_GRAD_SYM, and at config 3's N (B11 and B13 there too)."""
    n = N_DETERMINISM
    pos = to_dev(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    m = to_dev(rng.uniform(0.5, 2.0, n).astype(np.float32))
    g = normal(rng, n)
    block = SimConfig(n=N_CONFIG3).tile_i  # B10's as autodiff calls it
    runs = {
        "K2": lambda: sm.body_force_sym_mxu(pos, m, chunk=CHUNK,
                                            coincident="fast"),
        "K3": lambda: sf.body_force_symmetric(pos, m, chunk=CHUNK),
        "B11": lambda: vk.vjp_pos_sym(pos, g, m, 1e-2, chunk=CHUNK,
                                      mass_grad=True, coincident="fast"),
        "B13": lambda: vm.vjp_pos_sym_mxu(pos, g, m, 1e-2, chunk=CHUNK,
                                          mass_grad=True, coincident="fast"),
        "B16": lambda: sm.body_force_sym_mxu(pos, m, chunk=CHUNK,
                                             coincident="fast",
                                             traversal="band"),
        "B10": lambda: vk.vjp_pos_direct(pos, g, m, 1e-2, block=block,
                                         coincident="fast"),
        "B14": lambda: vm.vjp_rect_mxu(pos, g, pos, g, m, m, 1e-2,
                                       coincident="fast"),
    }
    reset_counts()
    for name, run in runs.items():
        first, second = _outputs(run()), _outputs(run())
        for a, b in zip(first, second):
            if not torch.equal(a, b):
                fail(f"determinism: two runs of {name} differ, max "
                     f"{(a - b).abs().max().item():.4g}")
    launches = read_counts()
    want = {}
    for kernel, tile, mod in (("slot", sm.DEFAULT_TILE, sm),
                              ("sym", sf.DEFAULT_TILE, sf),
                              ("vjp_sym", vk.DEFAULT_TILE, vk),
                              ("vjp_mxu", vm.DEFAULT_TILE, vm)):
        want[f"{kernel}_tri"], want[f"{kernel}_cross"] = pass_launches(
            n, tile, 2)
    want["band_tri"], want["band_cross"] = band_pass_launches(
        n, sm.DEFAULT_TILE, 2)
    want["vjp_ordered"] = want["vjp_rect_mxu"] = 2
    expect_counts(launches, "determinism", **want)
    # B10 and B14 drop the d2 == 0 select off their own tiles under 'fast':
    # on bodies with no d2 == 0 pair there, the bits of 'masked'.
    if vk.any_coincident(pos):
        fail("determinism: the uniform bodies hold a duplicate")
    fast_masked = []
    for name, masked in (
            ("B10", lambda: vk.vjp_pos_direct(pos, g, m, 1e-2, block=block,
                                              coincident="masked")),
            ("B14", lambda: vm.vjp_rect_mxu(pos, g, pos, g, m, m, 1e-2,
                                            coincident="masked"))):
        if not torch.equal(runs[name](), masked()):
            fail(f"determinism: {name} 'fast' is not bitwise 'masked'")
        fast_masked.append(name)
    # 'auto' with K2's gate at 0: the duplicate scan runs, finds nothing in
    # the uniform bodies and routes to the maskless kernel.
    p2 = pos[:N_GRAD_SYM].contiguous()
    route = "masked" if sm.any_coincident(p2) else "maskless"
    if route != "maskless":
        fail("determinism: the duplicate-free bodies route to masked")
    with gate_at(0, "K2", "B16"):
        for traversal in ("slots", "band"):
            ref = sm.body_force_sym_mxu(p2, coincident="masked",
                                        traversal=traversal)
            for mode in ("auto", "fast"):
                if not torch.equal(sm.body_force_sym_mxu(
                        p2, coincident=mode, traversal=traversal), ref):
                    fail(f"determinism: sym_mxu {mode} on the {traversal} "
                         "is not bitwise masked")
    remat = {}
    for rn in (N_GRAD_SYM, N_CONFIG3):
        gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
        state = init.plummer(rn, generator=gen, device=DEV)
        for backend in ("auto", "sym_mxu"):
            cfg = grad_cfg(rn, backend=backend)
            carry0 = init_carry(cfg, state)
            _, none = rollout_grad(cfg, carry0, "vel", "none")
            _, sqrt = rollout_grad(cfg, carry0, "vel", "sqrt")
            if not torch.equal(none, sqrt):
                fail(f"determinism: {backend} sqrt gradient at n={rn} is not "
                     "bitwise the unchecked one, max "
                     f"{(none - sqrt).abs().max().item():.4g}")
            remat[f"{backend} n={rn}"] = True
    line("determinism", n=n, chunk=CHUNK, two_runs_bitwise=list(runs),
         launches=launches,
         sym_mxu_auto_fast_bitwise_masked=["slots", "band"],
         sym_mxu_auto_route=route, n_auto=N_GRAD_SYM,
         fast_bitwise_masked=fast_masked,
         remat_sqrt_bitwise_none=remat, remat_n=[N_GRAD_SYM, N_CONFIG3])


def half_mass_radius(pos, mass):
    """Median distance from the center of mass, per system (B, N, 3)."""
    com = (pos * mass[..., None]).sum(1) / mass.sum(1, keepdim=True)
    return (pos - com[:, None, :]).norm(dim=-1).median(dim=1).values


def b9a_sums(pos, v, slots, tile, soft, n_sys, plain=False):
    """One B9a call over n_sys stacked systems (masked, as the sweep's
    'auto' runs), or its bf16-mode plain version system by system."""
    acc = torch.zeros((pos.shape[0], 8), device=DEV)
    if not plain:
        sp.tri_slot_sums_ensemble_(acc, pos, v, slots, tile, soft, n_sys)
        return acc
    c = pos.shape[0] // n_sys
    for i in range(n_sys):
        sl = slice(i * c, (i + 1) * c)
        sp._slot_sums_plain(acc[sl], acc[sl], pos[sl], pos[sl], v[sl], v[sl],
                            slots, tile, soft, False, True,
                            mma_dtype=torch.bfloat16)
    return acc


def sweep_case():
    """examples/parameter_sweep.py at its defaults: SWEEP_B copies of one
    plummer sphere of SWEEP_N with velocity scales q = 0.2 .. 1.6, and its
    config on sym_mxu with the streamed path pinned: (state, q, cfg)."""
    b, n = SWEEP_B, SWEEP_N
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    base = init.plummer(n, generator=gen, device=DEV)
    q = torch.linspace(0.2, 1.6, b, device=DEV)
    st = BodyState(pos=base.pos.expand(b, n, 3).contiguous(),
                   vel=(base.vel[None] * q[:, None, None]).contiguous(),
                   mass=base.mass.expand(b, n).contiguous())
    cfg = SimConfig(n=n, dt=SWEEP_DT, steps=SWEEP_STEPS, softening=SWEEP_SOFT,
                    integrator="leapfrog", use_masses=True, backend="sym_mxu",
                    resident=False)
    return st, q, cfg


def ensemble_sweep_phase():
    """examples/parameter_sweep.py at its defaults through
    simulate_ensemble on sym_mxu (B9a): per-system energy drift, the sweep
    trend (cold systems contract, hot ones expand), systems 0 and B - 1
    bitwise their standalone simulate at the ensemble's tile and chunk;
    then one B9a call (one launch: every system fits in one piece) held per
    column against its plain version and timed. Returns B9a's record."""
    b, n = SWEEP_B, SWEEP_N
    st, q, cfg = sweep_case()
    e0 = dg.total_energy_ensemble(st, SWEEP_SOFT)
    r0 = half_mass_radius(st.pos, st.mass)
    t, c = sm.ensemble_tiling(n, None, kernel=True)
    reset_counts()
    seconds, out = host_time(simulate_ensemble, cfg, st)
    launches = read_counts()
    expect_counts(launches, "ensemble_sweep", slot_ensemble=(
        SWEEP_STEPS + 1) * per_call(tri_slots(c, t), b))
    dg.assert_finite(out, "after the sweep")
    e1 = dg.total_energy_ensemble(out, SWEEP_SOFT)
    drift = ((e1 - e0) / e0).abs()
    ratio = half_mass_radius(out.pos, out.mass) / r0
    cold, hot = ratio[q < 0.5].mean().item(), ratio[q > 1.4].mean().item()
    if not (cold < 1.0 < hot):
        fail(f"ensemble_sweep: trend broken, cold {cold:.4g} hot {hot:.4g}")
    for i in (0, b - 1):
        one = BodyState(pos=st.pos[i], vel=st.vel[i], mass=st.mass[i])
        ref = simulate(cfg.replace(sym_tile=t, sym_chunk=c), one)
        if not (torch.equal(out.pos[i], ref.pos)
                and torch.equal(out.vel[i], ref.vel)):
            fail(f"ensemble_sweep: system {i} is not bitwise its simulate")
    pos_p, v = sm.pack_ensemble(st.pos, st.mass, c, sm._pack)
    slots = sp.slot_table(c // t, c // t > 1, False, DEV)
    args = (pos_p, v, slots, t, SWEEP_SOFT, b)
    ms = time_fn(b9a_sums, *args, reps=3) * 1e3
    got = b9a_sums(*args)
    plain_s, want = host_time(b9a_sums, *args, True)
    err = close_cols(got, want, K2_ATOL, f"B9a at B={b} N={n}")
    line("ensemble_sweep", b=b, n=n, steps=SWEEP_STEPS, tile=t, chunk=c,
         seconds=seconds, launches=launches, q=q.tolist(),
         energy_drift=drift.tolist(), max_energy_drift=drift.max().item(),
         r_half_ratio=ratio.tolist(), cold_ratio=cold, hot_ratio=hot,
         bitwise_systems=[0, b - 1], kernel_ms=ms, plain_ms=plain_s * 1e3,
         raw_sums_max_abs_err=err)
    pairs = b * n * (n - 1) / 2
    return slot_entry("slot_pipe tri mode, ensemble (B9a)", "slot_pipe.cu",
                      "slot_pipe.py:305", launches["slot_ensemble"], err, ms,
                      reduce_ms(slots, True, t, 8, c, b),
                      per_call(slots.shape[0], b), plain_s * 1e3,
                      bound(pairs * OPS_K2_FP32, b * c * (3 + 8 + 8) * 4.0,
                            pairs * OPS_K2_MMA, pairs), b=b, n=n, tile=t)


def ensemble_fp32_phase():
    """ENS_B plummer systems of N = ENS_N with masses on 'auto' (B9b),
    ENS_STEPS leapfrog steps of simulate_ensemble, each system bitwise its
    standalone simulate; one ensemble force pass timed beside its bound (a
    piece of the slot list holds one system here, so a pass is ENS_B
    launches per piece), and held against its plain version; then ENS_B
    systems of ENS_SMALL_N, all in one launch, each bitwise its standalone
    force. Returns B9b's record."""
    b, n = ENS_B, ENS_N
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    systems = [init.plummer(n, generator=gen, device=DEV) for _ in range(b)]
    st = BodyState(pos=torch.stack([s.pos for s in systems]),
                   vel=torch.stack([s.vel for s in systems]),
                   mass=torch.stack([s.mass for s in systems]))
    cfg = SimConfig(n=n, steps=ENS_STEPS, dt=1e-3, softening=1e-2,
                    integrator="leapfrog", use_masses=True)
    t, c = sm.ensemble_tiling(n, None, kernel=True)
    per = per_call(tri_slots(c, t), b)
    reset_counts()
    seconds, out = host_time(simulate_ensemble, cfg, st)
    launches = read_counts()
    expect_counts(launches, "ensemble_fp32",
                  sym_ensemble=(ENS_STEPS + 1) * per)
    dg.assert_finite(out, "after the fp32 ensemble")
    for i, one in enumerate(systems):
        ref = simulate(cfg.replace(sym_tile=t, sym_chunk=c), one)
        if not (torch.equal(out.pos[i], ref.pos)
                and torch.equal(out.vel[i], ref.vel)):
            fail(f"ensemble_fp32: system {i} is not bitwise its simulate")
    pass_ms = time_fn(sf.body_force_symmetric_ensemble, st.pos, st.mass,
                      cfg.softening, reps=3) * 1e3
    p = sm.pack_ensemble(st.pos, st.mass, c, sf._pack)
    slots = sp.slot_table(c // t, c // t > 1, False, DEV)
    got = torch.zeros((b * c, 3), device=DEV)
    sf.symmetric_sums_ensemble_(got, p, slots, t, cfg.softening, b)

    def plain():
        want = torch.zeros((b * c, 3), device=DEV)
        for i in range(b):
            sl = slice(i * c, (i + 1) * c)
            sf.symmetric_sums_plain(want[sl], want[sl], p[sl], p[sl], slots,
                                    t, cfg.softening)
        return want

    plain_s, want = host_time(plain)
    err = close(got, want, K3_RTOL, K3_ATOL, f"B9b at B={b} N={n}")
    pairs = b * n * (n - 1) / 2
    bnd = bound(pairs * OPS_PAIR_ONCE_MASS, b * n * (4 + 3) * 4.0,
                rsqrts=pairs)
    small = small_ensemble(b, ENS_SMALL_N, gen)
    line("ensemble_fp32", b=b, n=n, steps=ENS_STEPS, tile=t, chunk=c,
         seconds=seconds, launches=launches, bitwise_systems=b,
         launches_per_pass=per, pass_ms=pass_ms,
         pass_bound_ms=bnd["bound_ms"],
         pass_pairs_per_s=pairs / (pass_ms * 1e-3), plain_ms=plain_s * 1e3,
         max_abs_err=err, one_launch=small)
    return slot_entry("symmetric_force tri mode, ensemble (B9b)",
                      "symmetric_force.cu", "symmetric_force.py:488",
                      launches["sym_ensemble"], err, pass_ms,
                      reduce_ms(slots, True, t, 3, c, b), per, plain_s * 1e3,
                      bnd, b=b, n=n, tile=t, masses=True)


def small_ensemble(b, n, gen):
    """B9b with b systems of n bodies in one launch (the system axis of the
    kernel at work): each system bitwise its standalone
    body_force_symmetric at the ensemble's tile and chunk."""
    pos = torch.rand((b, n, 3), generator=gen, device=DEV) * 2 - 1
    mass = torch.rand((b, n), generator=gen, device=DEV) + 0.5
    t, c = sm.ensemble_tiling(n, None, kernel=True)
    reset_counts()
    f = sf.body_force_symmetric_ensemble(pos, mass)
    launches = read_counts()
    expect_counts(launches, "ensemble_fp32 one launch", sym_ensemble=1)
    for i in range(b):
        if not torch.equal(f[i], sf.body_force_symmetric(pos[i], mass[i],
                                                         tile=t, chunk=c)):
            fail(f"ensemble_fp32: system {i} of {b} x {n} is not bitwise "
                 f"its standalone force")
    return {"b": b, "n": n, "tile": t, "launches": launches["sym_ensemble"],
            "bitwise_systems": b}


def trajectory_phase():
    """trajectory at N_TRAJ on 'auto' (K3), TRAJ_STEPS leapfrog steps with a
    snapshot every TRAJ_EVERY: the last snapshot is bitwise simulate's
    final positions."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    state = init.plummer(N_TRAJ, generator=gen, device=DEV)
    cfg = SimConfig(n=N_TRAJ, dt=1e-3, softening=1e-2, integrator="leapfrog",
                    use_masses=True)
    reset_counts()
    seconds, (final, hist) = host_time(trajectory, cfg, state, TRAJ_STEPS,
                                       TRAJ_EVERY)
    launches = read_counts()
    expect_counts(launches, "trajectory", sym_tri=pass_launches(
        N_TRAJ, sf.DEFAULT_TILE, TRAJ_STEPS + 1)[0])
    if hist.shape != (TRAJ_STEPS // TRAJ_EVERY, N_TRAJ, 3):
        fail(f"trajectory: history of shape {tuple(hist.shape)}")
    ref = simulate(cfg, state, TRAJ_STEPS)
    if not (torch.equal(hist[-1], ref.pos) and torch.equal(final.vel,
                                                           ref.vel)):
        fail("trajectory: the last snapshot is not bitwise simulate's")
    line("trajectory", n=N_TRAJ, steps=TRAJ_STEPS, save_every=TRAJ_EVERY,
         seconds=seconds, launches=launches, snapshots=hist.shape[0],
         last_snapshot_bitwise_simulate=True)


#: The call of each kernel behind a coincident gate (GATES).
GATE_CALLS = {
    "K2": lambda p, g, mode: sm.body_force_sym_mxu(p, coincident=mode),
    "B16": lambda p, g, mode: sm.body_force_sym_mxu(p, coincident=mode,
                                                    traversal="band"),
    "B6": lambda p, g, mode: mf.body_force_mxu(
        p, p, pair_dtype="bfloat16", coincident=mode),
    "B10": lambda p, g, mode: vk.vjp_pos_direct(p, g, coincident=mode),
    "B11": lambda p, g, mode: vk.vjp_pos_sym(p, g, coincident=mode),
    "B13": lambda p, g, mode: vm.vjp_pos_sym_mxu(p, g, coincident=mode),
    "B14": lambda p, g, mode: vm.vjp_rect_mxu(p, g, p, g, coincident=mode),
}


def gate_times(kernel, p, g):
    """Median host milliseconds of 'masked' and of 'auto' with the kernel's
    gate at 0 (the duplicate scan, its host sync, then the maskless kernel):
    what a caller of each pays. One warm-up each, then GATE_REPS calls of
    each in turns (masked, auto, auto, masked, ...)."""
    call = GATE_CALLS[kernel]
    times = {"masked": [], "auto": []}
    with gate_at(0, kernel):
        for mode in times:
            call(p, g, mode)
        for r in range(GATE_REPS):
            order = ("masked", "auto") if r % 2 == 0 else ("auto", "masked")
            for mode in order:
                times[mode].append(host_time(call, p, g, mode)[0] * 1e3)
    return {mode: float(np.median(t)) for mode, t in times.items()}


def coincident_gate_phase(rng):
    """C3: for each kernel behind a coincident gate, 'masked' against
    'auto' with its gate at 0 (the duplicate scan, then the maskless
    kernel) on duplicate-free bodies at each N of GATE_NS; the smallest N
    from which the scan pays at every larger measured N (None: at no
    measured N), beside the gate the kernel has (None: 'auto' never
    scans)."""
    out = {}
    for name in GATE_CALLS:
        rows, pays_from = {}, None
        for n in GATE_NS:
            p = to_dev(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
            g = normal(rng, n)
            t = gate_times(name, p, g)
            rows[n] = {"masked_ms": t["masked"], "scan_maskless_ms": t["auto"]}
            if t["auto"] < t["masked"]:
                pays_from = n if pays_from is None else pays_from
            else:
                pays_from = None
        gate = getattr(*GATES[name])
        out[name] = {"scan_pays_from": pays_from,
                     "gate": None if math.isinf(gate) else gate,
                     "times": rows}
    scan_ms = {}
    for n in GATE_NS:
        p = to_dev(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
        sm.any_coincident(p)
        scan_ms[n] = float(np.median([host_time(sm.any_coincident, p)[0]
                                      * 1e3 for _ in range(GATE_REPS)]))
    line("coincident_gate", reps=GATE_REPS, kernels=out, scan_only_ms=scan_ms)


# ------------------------------------------------ grad_ensemble (B9c, B9d)

def ens_state(b, n, gen):
    """b plummer systems of n bodies with masses, stacked."""
    systems = [init.plummer(n, generator=gen, device=DEV) for _ in range(b)]
    return BodyState(pos=torch.stack([s.pos for s in systems]),
                     vel=torch.stack([s.vel for s in systems]),
                     mass=torch.stack([s.mass for s in systems]))


def ens_grad(force, pos, mass, system=None):
    """The forces and the gradient in pos of sum(sin(F)) (of system
    ``system`` alone when given) through the differentiable ensemble
    force."""
    p = pos.clone().requires_grad_(True)
    f = force(p, mass)
    torch.sin(f if system is None else f[system]).sum().backward()
    return f.detach(), p.grad


#: Per class: (backend, the ensemble VJP, the standalone VJP, the counter,
#: the VJP module's default tile, the counter of the forward).
ENS_VJPS = (("sym", vk.vjp_pos_sym_ensemble, vk.vjp_pos_sym,
             "vjp_sym_ensemble", vk, "sym_ensemble"),
            ("sym_mxu", vm.vjp_pos_sym_mxu_ensemble, vm.vjp_pos_sym_mxu,
             "vjp_mxu_ensemble", vm, "slot_ensemble"))


def ens_vjp_sums(mxu, pos, g, mass, tile, plain=False):
    """The raw sums (with the mass cotangent) of one B9c / B9d call over
    the systems of pos (B, N, 3), or of its plain version with the system
    axis (B9d's in bf16 mode)."""
    b, n = pos.shape[0], pos.shape[1]
    if mxu:
        (t, c), (p, gp, q) = vm.ensemble_sums_inputs(pos, g, mass, tile)
    else:
        t, c = sm.ensemble_tiling(n, tile, kernel=True)
        p = sm.pack_ensemble(pos, mass, c, sf._pack)
        gp = vk.pad_systems(g, c)
    slots = sp.slot_table(c // t, c // t > 1, False, DEV)
    acc = torch.zeros((b * c, 9 if mxu else 4), device=DEV)
    if mxu and plain:
        vm.vjp_mxu_sums_plain(acc, acc, p, p, gp, gp, q, q, slots, t, 1e-2,
                              True, mma_dtype=torch.bfloat16, n_sys=b)
    elif mxu:
        vm.vjp_mxu_sums_ensemble_(acc, p, gp, q, slots, t, 1e-2, b)
    elif plain:
        vk.vjp_sym_sums_plain(acc, acc, p, p, gp, gp, slots, t, 1e-2, True,
                              n_sys=b)
    else:
        vk.vjp_sym_sums_ensemble_(acc, p, gp, slots, t, 1e-2, b)
    return acc.view(b, c, -1)[:, :n]


def grad_ensemble_phase():
    """B9c and B9d on their path: for each class, the gradient of
    sum(sin(F)) through make_differentiable_ensemble_force for GENS_B
    plummer systems of GENS_N with masses (forward B9b / B9a, backward B9c
    / B9d, exact launch counts); each system's gradient and mass cotangent
    bitwise the standalone VJP at the same tile; a loss on system 0 leaves
    exact zeros in the others; GENS_B x GENS_SMALL_N in one launch, every
    system bitwise; the raw sums against the plain version with the system
    axis at GENS_CHECK_B x GENS_SMALL_N; then one backward timed beside its
    plain version and its bound. Returns the two records."""
    b, n = GENS_B, GENS_N
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    st = ens_state(b, n, gen)
    small = ens_state(b, GENS_SMALL_N, gen)
    out, records = {}, []
    for backend, ens, one, counter, mod, fwd_counter in ENS_VJPS:
        mxu = backend == "sym_mxu"
        cfg = SimConfig(n=n, backend=backend, use_masses=True, softening=1e-2)
        force = make_differentiable_ensemble_force(cfg)
        t_f, c_f = sm.ensemble_tiling(n, None, kernel=True)
        t, c = sm.ensemble_tiling(n, mod.DEFAULT_TILE, kernel=True)
        per = per_call(tri_slots(c, t), b)
        reset_counts()
        seconds, (f, grad) = host_time(ens_grad, force, st.pos, st.mass)
        launches = read_counts()
        expect_counts(launches, f"grad_ensemble {backend}", **{
            fwd_counter: per_call(tri_slots(c_f, t_f), b), counter: per})
        g = torch.cos(f)  # the cotangent of sum(sin(F))
        pbar, mbar = ens(st.pos, g, st.mass, cfg.softening, mass_grad=True)
        for i in range(b):
            gi = g[i].contiguous()
            ref = one(st.pos[i], gi, st.mass[i], cfg.softening, tile=t)
            ref_p, ref_m = one(st.pos[i], gi, st.mass[i], cfg.softening,
                               tile=t, mass_grad=True)
            if not (torch.equal(grad[i], ref) and torch.equal(pbar[i], ref_p)
                    and torch.equal(mbar[i], ref_m)):
                fail(f"grad_ensemble {backend}: system {i} is not bitwise "
                     "its standalone VJP")
        _, leak = ens_grad(force, st.pos, st.mass, system=0)
        if not (leak[0].abs().max() > 0
                and torch.equal(leak[1:], torch.zeros_like(leak[1:]))):
            fail(f"grad_ensemble {backend}: a loss on system 0 reached "
                 "other systems")
        # All GENS_B systems of GENS_SMALL_N in one launch.
        gs = torch.sin(7.0 * small.pos)
        reset_counts()
        bars = ens(small.pos, gs, small.mass, cfg.softening)
        one_launch = read_counts()[counter]
        if one_launch != 1:
            fail(f"grad_ensemble {backend}: {b} x {GENS_SMALL_N} took "
                 f"{one_launch} launches")
        for i in range(b):
            if not torch.equal(bars[i], one(small.pos[i], gs[i],
                                            small.mass[i], cfg.softening)):
                fail(f"grad_ensemble {backend}: system {i} of {b} x "
                     f"{GENS_SMALL_N} is not bitwise its standalone VJP")
        # The kernel against its plain version at GENS_CHECK_B systems.
        k = slice(0, GENS_CHECK_B)
        got, want = (ens_vjp_sums(mxu, small.pos[k], gs[k], small.mass[k],
                                  mod.DEFAULT_TILE, plain=pl)
                     for pl in (False, True))
        if mxu:
            check_err = close_cols(got.reshape(-1, 9), want.reshape(-1, 9),
                                   K2_ATOL, "B9d vs bf16 plain")
        else:
            check_err = close_grad(got, want, K1_RTOL, K1_ATOL,
                                   "B9c vs plain")
        # One backward at full size, timed, and its plain version.
        args = (st.pos, g, st.mass, cfg.softening)
        call_ms = time_fn(ens, *args, reps=3) * 1e3
        got = ens(*args)
        with plain_versions():
            plain_s, want = host_time(ens, *args)
        bound_rt = (SYM_RTOL, SYM_ATOL) if mxu else (K1_RTOL, K1_ATOL)
        err = close_grad(got, want, *bound_rt, f"{backend} ensemble VJP "
                         "vs plain")
        slots = sp.slot_table(c // t, True, False, DEV)
        red = reduce_ms(slots, True, t, 8 if mxu else 3, c, b)
        pairs = b * n * (n - 1) / 2
        bnd = (bound(pairs * OPS_B13_FP32, b * n * 40.0, pairs * OPS_B13_MMA)
               if mxu else bound(pairs * OPS_B11, b * n * 40.0))
        out[backend] = {"seconds": seconds, "launches": launches,
                        "tile": t, "bitwise_systems": b,
                        "small_one_launch_bitwise": b,
                        "check_vs_plain_max_abs_err": check_err,
                        "backward_ms": call_ms,
                        "backward_bound_ms": bnd["bound_ms"],
                        "plain_ms": plain_s * 1e3,
                        "vs_plain_max_err_of_scale": scale_err(got, want)}
        name = ("vjp_mxu pair-once, ensemble (B9d)" if mxu
                else "vjp_kernel pair-once, ensemble (B9c)")
        records.append(slot_entry(
            name, "vjp_mxu.cu" if mxu else "vjp_kernel.cu",
            "vjp_mxu.py:430" if mxu else "vjp_kernel.py:483",
            launches[counter], err, call_ms, red, per, plain_s * 1e3, bnd,
            b=b, n=n, tile=t, body=body_info("B13" if mxu else "B11")))
    line("grad_ensemble", b=b, n=n, loss="sum(sin(F))", runs=out)
    return records


# ---------------------------------------------------------- resident (B15)

def res_cfg(n, backend, **kw):
    """A resident config: plummer physics (softening 1e-2, dt 1e-3, masses)
    unless kw says otherwise."""
    return SimConfig(n=n, **{**dict(dt=1e-3, softening=1e-2, use_masses=True,
                                    backend=backend), **kw})


def res_bound(mxu):
    return RES_BF16 if mxu else RES_FP32


def res_vs_streamed(cfg, state, what, **want):
    """simulate with resident=True (launches held to ``want``) against
    resident=False: bitwise, as sim.py's docstring says; returns a
    summary."""
    reset_counts()
    seconds, out = host_time(simulate, cfg.replace(resident=True), state)
    launches = read_counts()
    expect_counts(launches, what, **want)
    stream_s, ref = host_time(simulate, cfg.replace(resident=False), state)
    if not (torch.equal(out.pos, ref.pos) and torch.equal(out.vel, ref.vel)):
        fail(f"{what}: the resident run is not bitwise the streamed run "
             f"(max err of scale: pos {scale_err(out.pos, ref.pos):.3g}, "
             f"vel {scale_err(out.vel, ref.vel):.3g})")
    return {"seconds": seconds, "streamed_seconds": stream_s,
            "launches": launches, "bitwise_streamed": True}


def res_plain(s, masses, steps, dt, softening, mxu):
    """B15's plain version on the card's tensors (bf16 mode in the bf16
    class): (pos, vel) after ``steps`` Euler steps of one system at B15's
    default tile and fold."""
    n = s.pos.shape[0]
    tile = rs.auto_tile(n)
    pad = -(-n // tile) * tile - n
    p = torch.cat([s.pos, s.pos.new_full((pad, 3), 1.0e18)])[None]
    v = torch.cat([s.vel, s.vel.new_zeros((pad, 3))])[None]
    m = torch.cat([s.mass, s.mass.new_zeros(pad)])[None] if masses else None
    nb = p.shape[1] // tile
    slots = sp.slot_table(nb, rs.FOLD_DEFAULT and nb >= 2, False, DEV)
    rs.resident_plain(p, v, m, slots, tile, n, steps, dt, softening, mxu,
                      True, mma_dtype=torch.bfloat16 if mxu else torch.float32)
    return p[0, :n], v[0, :n]


def res_vs_plain(s, masses, steps, dt, softening, mxu, tol, what):
    """B15 against its plain version on one system: the change of velocity
    and of position over the run, each within tol of its own scale.
    Returns (max abs error of pos and vel, {change: error of scale}, the
    plain version's seconds)."""
    got = rs.simulate_resident_sym(s.pos, s.vel, s.mass if masses else None,
                                   steps=steps, dt=dt, softening=softening,
                                   mxu=mxu)
    plain_s, want = host_time(res_plain, s, masses, steps, dt, softening, mxu)
    errs = {}
    for g, w, x0, name in zip(got, want, (s.pos, s.vel), ("pos", "vel")):
        dg_, dw = g.double() - x0.double(), w.double() - x0.double()
        close(dg_, dw, 0.0, tol, f"{what}: {name} change vs plain", floor=0.0)
        errs[f"{name}_change"] = scale_err(dg_, dw)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    return err, errs, plain_s


def resident_phase():
    """B15 on its paths, in both classes (module docstring), each path with
    every count set to 0 just before it; then B15 on config 1 against its
    plain version, timed beside it and its bound. Returns the two
    records."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    out, records = {}, []
    s1 = init.uniform_random(N_CONFIG1, generator=gen, device=DEV)
    s4k = init.plummer(N_CONFIG1, generator=gen, device=DEV)
    s2 = init.plummer(N_CONFIG2, generator=gen, device=DEV)
    cap = init.plummer(rs.RESIDENT_SYM_MAX_N, generator=gen, device=DEV)
    sp_ = init.plummer(RES_PLAIN_N, generator=gen, device=DEV)
    for backend in ("auto", "sym_mxu"):
        mxu = backend == "sym_mxu"
        runs = {}
        cfg1 = SimConfig(n=N_CONFIG1, steps=STEPS_CONFIG1, dt=DT_CONFIG1,
                         backend=backend)
        runs["config1"] = res_vs_streamed(cfg1, s1, f"config1 {backend}",
                                          resident=1)
        for integ in ("leapfrog", "yoshida4"):
            cfg = res_cfg(N_CONFIG1, backend, steps=RES_LONG_STEPS,
                          integrator=integ)
            runs[integ] = res_vs_streamed(cfg, s4k, f"{integ} {backend}",
                                          resident=1)
        runs["config2"] = res_vs_streamed(
            res_cfg(N_CONFIG2, backend, steps=RES_CONFIG2_STEPS), s2,
            f"config2 {backend}", resident=1)
        runs["cap"] = res_vs_streamed(
            res_cfg(rs.RESIDENT_SYM_MAX_N, backend, steps=RES_CAP_STEPS),
            cap, f"cap {backend}", resident=1)
        # Reruns and a split Yoshida-4 phase, bitwise.
        cycle, _ = rs.y4_cycle(1e-3)
        kw = dict(dt=1e-3, softening=1e-2, mxu=mxu, y4=cycle)
        one = rs.simulate_resident_sym(s4k.pos, s4k.vel, s4k.mass, steps=8,
                                       **kw)
        again = rs.simulate_resident_sym(s4k.pos, s4k.vel, s4k.mass,
                                         steps=8, **kw)
        p, v = s4k.pos, s4k.vel
        for start, k in ((0, 3), (3, 4), (7, 1)):
            p, v = rs.simulate_resident_sym(p, v, s4k.mass, steps=k,
                                            y4_phase=start, **kw)
        if not all(torch.equal(a, b) for a, b in ((one[0], again[0]),
                                                  (one[1], again[1]),
                                                  (p, one[0]), (v, one[1]))):
            fail(f"resident {backend}: reruns or a split Yoshida-4 phase "
                 "are not bitwise one run")
        # C4: a ragged N whose pads sit in a fold, coincident 'fast'.
        n4 = N_CONFIG1 - 96  # at tile 128 the pads sit in block 31, folded
        kw = dict(steps=20, dt=1e-3, softening=1e-9, mxu=mxu, tile=128,
                  fold=True)
        fast = rs.simulate_resident_sym(s1.pos[:n4], s1.vel[:n4], None,
                                        coincident="fast", **kw)
        masked = rs.simulate_resident_sym(s1.pos[:n4], s1.vel[:n4], None,
                                          coincident="masked", **kw)
        for a, b in zip(fast, masked):
            close(a, b, *res_bound(mxu), f"C4 fast fold {backend}")
        # B15 against its plain version: config 1 (one step and the run),
        # and plummer bodies with masses.
        vs_plain = {}
        for case, (s, masses, steps, dt, soft) in {
                "config1_1step": (s1, False, 1, DT_CONFIG1, SOFTENING),
                "config1": (s1, False, STEPS_CONFIG1, DT_CONFIG1, SOFTENING),
                "plummer": (sp_, True, RES_PLAIN_STEPS, 1e-3, 1e-2)}.items():
            vs_plain[case] = res_vs_plain(s, masses, steps, dt, soft, mxu,
                                          RES_PLAIN_TOL[case][mxu],
                                          f"B15 {backend} {case}")
        err, _, plain_s = vs_plain["config1"]

        # Timed on config 1.
        def config1():
            return rs.simulate_resident_sym(s1.pos, s1.vel, None,
                                            steps=STEPS_CONFIG1,
                                            dt=DT_CONFIG1, mxu=mxu)

        ms = time_fn(config1, reps=3) * 1e3
        # Leapfrog and Yoshida-4 calls of config 1's steps (one launch
        # each, the end passes included).
        kdk_ms = {integ: time_fn(lambda fn=fn: fn(
            s1.pos, s1.vel, None, steps=STEPS_CONFIG1, dt=DT_CONFIG1,
            mxu=mxu), reps=3) * 1e3 for integ, fn in (
                ("leapfrog", rs.simulate_resident_sym_leapfrog),
                ("yoshida4", rs.simulate_resident_sym_yoshida4))}
        n = float(N_CONFIG1)
        pairs = STEPS_CONFIG1 * n * (n - 1) / 2
        bnd = (bound(pairs * OPS_K2_FP32, n * BYTES_B15, pairs * OPS_K2_MMA,
                     pairs)
               if mxu else bound(pairs * OPS_B15, n * BYTES_B15,
                                 rsqrts=pairs))
        runs.update(fold_c4_finite=True, config1_launch_ms=ms,
                    config1_leapfrog_ms=kdk_ms["leapfrog"],
                    config1_yoshida4_ms=kdk_ms["yoshida4"],
                    config1_plain_ms=plain_s * 1e3,
                    vs_plain={k: {"max_abs_err": e, "err_of_scale": sc}
                              for k, (e, sc, _) in vs_plain.items()})
        out[backend] = runs
        records.append(entry(
            f"resident_sym {'bf16' if mxu else 'fp32'} class (B15)",
            "resident_sym.cu", "resident_sym.py:441",
            runs["config1"]["launches"]["resident"], err, ms, plain_s * 1e3,
            bnd, n=N_CONFIG1, steps=STEPS_CONFIG1, tile=rs.auto_tile(
                N_CONFIG1), per="launch (a whole trajectory)"))
    out["sweep"] = resident_sweep()
    out["b15_bodies"] = b15_bodies()
    line("resident", runs=out)
    return records


def b15_bodies():
    """B15's registers, spills and CTAs per SM for every instantiation
    (tile, class; in the fp32 class k = 3 or 4 and the fast rsqrt or not;
    in the bf16 class the narrow and the wide one): the fp32 class must
    hold at least 2 CTAs an SM with no spills, K3's 16 warps at tile 128 (2
    CTAs of 256 threads) and 12 at tile 64, the bf16 class no fewer CTAs
    per SM than K2."""
    out = {}
    for tile in rs.RESIDENT_TILES:
        k2 = body_info("K2", ("slot_pipe_info", (tile, 0),
                              f"slot_pipe_kernelILi{tile}ELb0E"))
        fp32_warps = 16 if tile == 128 else 12
        for mxu, k, fast, wide in ((False, 3, 0, 0), (False, 3, 1, 0),
                                   (False, 4, 0, 0), (False, 4, 1, 0),
                                   (True, 3, 1, 0), (True, 3, 1, 1)):
            name = (f"tile {tile} bf16 {'wide' if wide else 'narrow'}"
                    if mxu else f"tile {tile} fp32 k={k} fast={fast}")
            warps = (16 if wide else 12) if mxu else fp32_warps
            got = body_info("B15", (
                "resident_sym_info", (tile, int(mxu), k, fast, wide),
                f"resident_kernelILi{tile}ELb{int(mxu)}ELi{k}"
                f"ELb{0 if mxu else fast}ELi{warps}E"))
            have = got["ctas_per_sm"] * (
                tile // 32 if mxu else (tile // 8) ** 2 // 32)
            if (got["ctas_per_sm"] < k2["ctas_per_sm"] if mxu else
                    got["local_bytes"] != 0 or got["ctas_per_sm"] < 2
                    or have < warps):
                fail(f"B15 {name}: {got} (K2 at this tile: {k2})")
            out[name] = got
    return out


def resident_sweep():
    """examples/parameter_sweep.py at its defaults on the resident ensemble
    (one B15 launch, its end passes included): systems 0 and B - 1 bitwise
    their standalone resident runs at the ensemble's tiles, and the sweep
    bitwise the streamed ensemble."""
    b, n = SWEEP_B, SWEEP_N
    st, q, cfg = sweep_case()
    cfg = cfg.replace(resident=True)
    t, c = sm.ensemble_tiling(n, None, kernel=True)
    reset_counts()
    seconds, res = host_time(simulate_ensemble, cfg, st)
    launches = read_counts()
    expect_counts(launches, "resident sweep", resident=1)
    for i in (0, b - 1):
        one = BodyState(pos=st.pos[i], vel=st.vel[i], mass=st.mass[i])
        ref = simulate(cfg.replace(sym_tile=t, sym_chunk=c), one)
        if not (torch.equal(res.pos[i], ref.pos)
                and torch.equal(res.vel[i], ref.vel)):
            fail(f"resident sweep: system {i} is not bitwise its standalone "
                 "resident run")
    stream_s, ref = host_time(simulate_ensemble, cfg.replace(resident=False),
                              st)
    if not (torch.equal(res.pos, ref.pos) and torch.equal(res.vel, ref.vel)):
        fail("resident sweep: not bitwise the streamed ensemble (max err of "
             f"scale {scale_err(res.pos, ref.pos):.3g})")
    e0 = dg.total_energy_ensemble(st, SWEEP_SOFT)
    drift = ((dg.total_energy_ensemble(res, SWEEP_SOFT) - e0) / e0).abs()
    return {"b": b, "n": n, "steps": SWEEP_STEPS, "seconds": seconds,
            "streamed_seconds": stream_s, "launches": launches,
            "bitwise_systems": [0, b - 1], "bitwise_streamed": True,
            "max_energy_drift": drift.max().item()}


# -------------------------------------------------- resident_crossover

def per_step_ms(variants, steps):
    """Median host ms per step of each variant (a callable running
    ``steps`` steps): one warm-up each, then CROSS_REPS turns, the order
    rotated each turn."""
    for fn in variants.values():
        fn()
    times = {k: [] for k in variants}
    keys = list(variants)
    for r in range(CROSS_REPS):
        for k in keys[r % len(keys):] + keys[:r % len(keys)]:
            times[k].append(host_time(variants[k])[0] * 1e3 / steps)
    return {k: float(np.median(v)) for k, v in times.items()}


def crossover(rows, key):
    """The largest measured size from which down every smaller measured
    size had B15 (at the fold default) faster than the streamed loop; None
    if it lost at the smallest."""
    best = None
    for size, t in rows:
        if t[key] >= t["streamed"]:
            break
        best = size
    return best


def first_won(rows, max_n):
    """The fewest steps k of CROSS_SHORT_STEPS from which on the resident
    route won every measured short run of at most max_n bodies per system
    (rows: {(label, n, k): {"resident", "streamed"}}); None if it lost at
    the longest."""
    best = None
    for k in sorted(CROSS_SHORT_STEPS, reverse=True):
        if any(t["resident"] >= t["streamed"]
               for (_, n, kk), t in rows.items() if kk == k and n <= max_n):
            break
        best = k
    return best


def short_runs(backend, gen):
    """Whole simulate and simulate_ensemble calls of CROSS_SHORT_STEPS
    steps of each integrator, resident=True against resident=False (median
    ms per call), up to CROSS_SHORT_MAX_N and CROSS_SHORT_MAX_ENS_N; per
    integrator, the fewest steps from which the resident route won every
    run at the sizes sim.py routes."""
    eff = "sym" if backend == "auto" else backend
    out = {}
    for integ in ("euler", "leapfrog", "yoshida4"):
        single, ens = {}, {}
        cases = ([(str(n), n, None) for n in CROSS_NS
                  if n <= CROSS_SHORT_MAX_N]
                 + [(f"{b}x{n}", n, b) for b, n in CROSS_ENS
                    if n <= CROSS_SHORT_MAX_ENS_N])
        for label, n, b in cases:
            if b is None:
                st, run, rows = (init.uniform_random(n, generator=gen,
                                                     device=DEV),
                                 simulate, single)
            else:
                pos = torch.rand((b, n, 3), generator=gen, device=DEV) * 2 - 1
                st, run, rows = (BodyState(pos=pos, vel=torch.zeros_like(pos),
                                           mass=torch.ones((b, n),
                                                           device=DEV)),
                                 simulate_ensemble, ens)
            for k in CROSS_SHORT_STEPS:
                cfg = SimConfig(n=n, steps=k, dt=1e-4, backend=backend,
                                integrator=integ)
                rows[label, n, k] = per_step_ms({
                    "resident": lambda: run(cfg.replace(resident=True), st),
                    "streamed": lambda: run(cfg.replace(resident=False),
                                            st)}, 1)
        out[integ] = {
            "single_ms_per_call": {f"{lb} {k}": t
                                   for (lb, _, k), t in single.items()},
            "ensemble_ms_per_call": {f"{lb} {k}": t
                                     for (lb, _, k), t in ens.items()},
            "single_won_from_steps": first_won(
                single, tsim.RESIDENT_AUTO_MAX_N[eff]),
            "ensemble_won_from_steps": first_won(
                ens, tsim.RESIDENT_ENSEMBLE_AUTO_MAX_N[eff])}
    return out


def resident_crossover_phase():
    """ms per Euler step of B15 with fold on and off against the streamed
    loop (K3 or K2 per pass plus the integrate), one system at each N of
    CROSS_NS and ensembles at CROSS_ENS against B9b / B9a, in both classes
    (uniform bodies, unit masses, dt 1e-4); the crossovers and where fold
    wins; then the short runs (short_runs); beside the values sim.py routes
    by."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    out = {}
    steps = CROSS_STEPS
    dflt = "fold" if rs.FOLD_DEFAULT else "nofold"
    for backend in ("auto", "sym_mxu"):
        mxu = backend == "sym_mxu"
        single, ens = [], []
        for n in CROSS_NS:
            s = init.uniform_random(n, generator=gen, device=DEV)
            cfg = SimConfig(n=n, steps=steps, dt=1e-4, backend=backend,
                            resident=False)
            kw = dict(steps=steps, dt=1e-4, softening=cfg.softening, mxu=mxu)
            single.append((n, per_step_ms({
                "streamed": lambda: simulate(cfg, s),
                "fold": lambda: rs.simulate_resident_sym(
                    s.pos, s.vel, None, fold=True, **kw),
                "nofold": lambda: rs.simulate_resident_sym(
                    s.pos, s.vel, None, fold=False, **kw)}, steps)))
        for b, n in CROSS_ENS:
            pos = torch.rand((b, n, 3), generator=gen, device=DEV) * 2 - 1
            st = BodyState(pos=pos, vel=torch.zeros_like(pos),
                           mass=torch.ones((b, n), device=DEV))
            cfg = SimConfig(n=n, steps=steps, dt=1e-4, backend=backend,
                            resident=False)
            kw = dict(steps=steps, dt=1e-4, softening=cfg.softening, mxu=mxu)
            ens.append(((b, n), per_step_ms({
                "streamed": lambda: simulate_ensemble(cfg, st),
                "fold": lambda: rs.simulate_resident_sym_ensemble(
                    st.pos, st.vel, None, fold=True, **kw),
                "nofold": lambda: rs.simulate_resident_sym_ensemble(
                    st.pos, st.vel, None, fold=False, **kw)}, steps)))
        fold_wins = [size for size, t in single + ens
                     if t["fold"] < t["nofold"]]
        ens_cross = crossover(ens, dflt)
        out[backend] = {
            "single_ms_per_step": {n: t for n, t in single},
            "ensemble_ms_per_step": {f"{b}x{n}": t for (b, n), t in ens},
            "crossover_n": crossover(single, dflt),
            "ensemble_crossover_n": None if ens_cross is None else
            ens_cross[1],
            "fold_faster_at": [str(x) for x in fold_wins],
            "sim_routes_up_to": tsim.RESIDENT_AUTO_MAX_N.get(
                "sym" if backend == "auto" else backend),
            "sim_routes_ensembles_up_to": tsim.RESIDENT_ENSEMBLE_AUTO_MAX_N
            .get("sym" if backend == "auto" else backend),
            "short_runs": short_runs(backend, gen),
            "sim_routes_from_steps": tsim.RESIDENT_AUTO_MIN_STEPS}
    line("resident_crossover", steps=steps, reps=CROSS_REPS,
         fold_default=rs.FOLD_DEFAULT, classes=out)


def b12_tile(pos, mass, shape):
    """The (row group, column group) bodies of rank (0, 0) of a (Pi, Pj)
    grid over pos (the blocks of ranks 0 .. Pj - 1, and of ranks 0, Pj, 2
    Pj, ..), with their masses."""
    pi, pj = shape
    blk = pos.shape[0] // (pi * pj)

    def rows(ranks):
        idx = torch.cat([torch.arange(r * blk, (r + 1) * blk, device=DEV)
                         for r in ranks])
        return pos[idx].contiguous(), mass[idx].contiguous()

    return rows(range(pj)), rows(range(0, pi * pj, pj))


def b12_bound(na, nb):
    """B12's bound: 26 fp32 operations per ordered pair; bytes: pos_a, g_a,
    pos_b and m_b in, a_bar and b_bar out."""
    return bound(float(na) * nb * OPS_B12, (na * 9 + nb * 7) * 4.0)


def b12_launches(na, nb):
    """B12's launches per call of na x nb bodies: one per piece of its
    cross slot table (each followed by one slot_reduce)."""
    tile = vk.PAIR_TILE
    return per_call(-(-na // tile) * -(-nb // tile))


def b12_phase(rng):
    """B12 (vjp_pos_pair) against vjp_pos_pair_plain on the card: the tile
    of rank (0, 0) of a 2 x 2 and a 4 x 2 grid over config 3's plummer
    state (131,072 x 131,072 sharing half the bodies, 65,536 x 131,072
    sharing a quarter), and a ragged 3001 x 9001, with masses and unit
    masses, at K1's bound on each output's scale; every call twice,
    bitwise. Then B12 on the whole pair matrix (262,144 x 262,144, a 1 x 1
    grid, what the grid gradient of the sharded phase gives it) against its
    plain version at the same bound, and timed beside its bound, its plain
    version and its slot_reduce launches (B12's tile is
    vjp_kernel.PAIR_TILE). Returns (its max error, its kernels-line record
    without its launches)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 14)
    state = init.plummer(N_CONFIG3, generator=gen, device=DEV)
    soft = 1e-2
    cases = []
    for shape in B12_TILES:
        (pa, ma), (pb, mb) = b12_tile(state.pos, state.mass, shape)
        cases.append((f"grid {shape}", pa, ma, pb, mb))
    na, nb = B12_RAGGED
    pr = to_dev(rng.uniform(-1, 1, (na + nb, 3)).astype(np.float32))
    mr = to_dev(rng.uniform(0.5, 2.0, na + nb).astype(np.float32))
    cases.append(("ragged", pr[:na], mr[:na], pr[na:], mr[na:]))
    errs, of_scale, shapes = [], [], []
    for what, pa, ma, pb, mb in cases:
        g = normal(rng, pa.shape[0])
        per = b12_launches(pa.shape[0], pb.shape[0])
        for masses in (True, False):
            m = (ma, mb) if masses else (None, None)
            reset_counts()
            got = vk.vjp_pos_pair(pa, g, pb, *m, softening=soft)
            again = vk.vjp_pos_pair(pa, g, pb, *m, softening=soft)
            expect_counts(read_counts(), f"b12 {what}", vjp_pair=2 * per)
            want = vk.vjp_pos_pair_plain(pa, g, pb, *m, softening=soft)
            for a, b, w, side in zip(got, again, want, ("a_bar", "b_bar")):
                if not torch.equal(a, b):
                    fail(f"B12 {what} masses={masses}: {side} differs "
                         "between two runs")
                errs.append(close_grad(a, w, K1_RTOL, K1_ATOL,
                                       f"B12 {what} masses={masses} "
                                       f"{side}"))
                of_scale.append(scale_err(a, w))
        shapes.append([what, pa.shape[0], pb.shape[0], per])
    g = normal(rng, N_CONFIG3)
    args = (state.pos, g, state.pos, None, state.mass, soft)
    per = b12_launches(N_CONFIG3, N_CONFIG3)
    reset_counts()
    got = vk.vjp_pos_pair(*args)
    expect_counts(read_counts(), "b12 whole pair matrix", vjp_pair=per)
    plain_s, want = host_time(vk.vjp_pos_pair_plain, *args)
    whole = [close_grad(a, w, K1_RTOL, K1_ATOL,
                        f"B12 {N_CONFIG3}^2 {side}")
             for a, w, side in zip(got, want, ("a_bar", "b_bar"))]
    of_scale += [scale_err(a, w) for a, w in zip(got, want)]
    shapes.append(["whole", N_CONFIG3, N_CONFIG3, per])
    err = max(errs + whole)
    call_ms = time_fn(vk.vjp_pos_pair, *args, reps=3) * 1e3
    tile = vk.PAIR_TILE
    n_p = -(-N_CONFIG3 // tile) * tile
    red_ms = reduce_ms(sp.slot_table(n_p // tile, False, True, DEV), False,
                       tile, 3, n_p)
    bnd = b12_bound(N_CONFIG3, N_CONFIG3)
    line("b12_vs_plain", cases=shapes, masses=[True, False],
         max_abs_err=err, max_err_of_scale=max(of_scale),
         whole_max_abs_err=max(whole), bitwise_rerun=True, n=N_CONFIG3,
         tile=tile, call_ms=call_ms, slot_reduce_ms=red_ms,
         plain_ms=plain_s * 1e3, **bnd, share=bnd["bound_ms"] / call_ms)
    return err, slot_entry("vjp_pos_pair (B12)", "vjp_kernel.cu",
                           "vjp_kernel.py:831", 0, max(whole), call_ms,
                           red_ms, per, plain_s * 1e3, bnd, n=N_CONFIG3,
                           tile=tile, body=body_info("B12"))


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL process group on DEV (rendezvous through a file in
    a temporary directory), destroyed on the way out."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/rdv",
                                world_size=1, rank=0, device_id=DEV)
        try:
            yield
        finally:
            dist.destroy_process_group()


def sharded_grad(step, state, acc):
    """Gradient of sum(vel^2) after one step from (state, acc) in the
    initial positions (the acceleration carry held constant)."""
    p = state.pos.clone().requires_grad_(True)
    out, _ = step((BodyState(pos=p, vel=state.vel, mass=state.mass), acc))
    (out.vel ** 2).sum().backward()
    torch.cuda.synchronize()
    if not torch.isfinite(p.grad).all():
        fail("sharded gradient: non-finite")
    return p.grad


def sharded_phase():
    """The sharded path on a one-rank NCCL group (module docstring): every
    comm at config 4's N bitwise the single-card run on its shard's kernel,
    with exact kernel and collective counts (at P = 1 a gather or a
    reduce-scatter is an identity; ring and ring_sym make no hop); config
    3's gradient through one differentiable step under grid (B12) and ring
    on sym_mxu (B14) against the single card's (B10); the sweep with a
    mesh bitwise the unsharded ensemble. Returns the B12 launches of the
    grid gradient."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    state = init.uniform_random(N_MAIN, generator=gen, device=DEV)
    base = SimConfig(n=N_MAIN, steps=SHARDED_STEPS, integrator="euler")
    tri, cross = pass_launches(N_MAIN, sf.DEFAULT_TILE, SHARDED_STEPS)
    k1 = dict(direct=SHARDED_STEPS)
    k3 = dict(sym_tri=tri, sym_cross=cross)
    # comm, backend, mesh shape, the single-card run it is bitwise, its
    # kernel launches and collectives (every run gathers its state once).
    runs = [("all_gather", "auto", (1,), "direct", k1,
             dict(all_gather=SHARDED_STEPS + 1)),
            ("ring", "auto", (1,), "sym", k3, dict(all_gather=1)),
            ("ring_sym", "auto", (1,), "sym", k3, dict(all_gather=1)),
            ("grid", "direct", (1, 1), "direct", k1,
             dict(all_gather=2 * SHARDED_STEPS + 1,
                  reduce_scatter=SHARDED_STEPS)),
            ("all_gather", "sym_mxu", (1,), "mxu", dict(mxu=SHARDED_STEPS),
             dict(all_gather=SHARDED_STEPS + 1))]
    out = {"forward": [], "single_ms_per_step": {}}
    with one_rank_group():
        meshes = {(1,): make_mesh((1,)), (1, 1): make_mesh((1, 1))}
        singles = {}
        for single in ("direct", "sym", "mxu"):
            cfg = base.replace(backend=single, pair_dtype="bfloat16")
            simulate(cfg, state, 1)  # warm: first-use costs (slot plans)
            secs, singles[single] = host_time(simulate, cfg, state)
            out["single_ms_per_step"][single] = secs / SHARDED_STEPS * 1e3
        for comm, backend, shape, single, kern, calls in runs:
            cfg = base.replace(backend=backend, comm=comm, mesh_shape=shape)
            reset_counts()
            secs, got = host_time(simulate_sharded, cfg, meshes[shape],
                                  state)
            what = f"sharded {comm} on {backend}"
            expect_counts(read_counts(), what, **kern)
            comm_calls = expect_calls(what, **calls)
            ref = singles[single]
            if not (torch.equal(got.pos, ref.pos)
                    and torch.equal(got.vel, ref.vel)):
                fail(f"{what}: not bitwise the single-card {single} run")
            out["forward"].append({
                "comm": comm, "backend": backend, "mesh": shape,
                "bitwise_single_card": single, "collectives": comm_calls,
                "ms_per_step": secs / SHARDED_STEPS * 1e3,
                "single_ms_per_step":
                    out["single_ms_per_step"][single]})
        grads, b12 = sharded_grads(meshes, out)
        out["gradients"] = grads
        out["ensemble"] = sharded_ensemble(meshes[(1,)])
        out["checkpoint"] = sharded_checkpoint(meshes[(1,)], state)
    line("sharded", n=N_MAIN, steps=SHARDED_STEPS, **out)
    return b12


def sharded_grads(meshes, out):
    """Config 3's one-step gradients under grid (B12) and ring on sym_mxu
    (B14), against the single card's B11 gradient; returns (their records,
    the B12 launches of the grid run)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 15)
    s3 = init.plummer(N_CONFIG3, generator=gen, device=DEV)
    cfg = grad_cfg(N_CONFIG3)
    with torch.no_grad():
        acc = init_carry(cfg, s3)[1]
    reset_counts()
    secs, want = host_time(sharded_grad,
                           tsim.make_step_fn(cfg, differentiable=True), s3,
                           acc)
    tri, cross = pass_launches(N_CONFIG3, sf.DEFAULT_TILE)
    b11_tri, b11_cross = pass_launches(N_CONFIG3, vk.DEFAULT_TILE)
    expect_counts(read_counts(), "single-card gradient", sym_tri=tri,
                  sym_cross=cross, vjp_sym_tri=b11_tri,
                  vjp_sym_cross=b11_cross)
    recs = {"single_card_b11_s": secs}
    m_tri, m_cross = pass_launches(N_CONFIG3, sm.DEFAULT_TILE)
    for comm, backend, shape, tol, kern, calls in (
            ("grid", "direct", (1, 1), (K1_RTOL, K1_ATOL),
             dict(direct=1, vjp_pair=b12_launches(N_CONFIG3, N_CONFIG3)),
             dict(all_gather=3 + 4, reduce_scatter=1 + 2)),
            ("ring", "sym_mxu", (1,), (SYM_RTOL, SYM_ATOL),
             dict(slot_tri=m_tri, slot_cross=m_cross, vjp_rect_mxu=1),
             dict(all_gather=3))):
        c = cfg.replace(backend=backend, comm=comm, mesh_shape=shape)
        mesh = meshes[shape]
        local = psh.shard_state(s3, mesh)
        step = psh.make_sharded_step_fn(c, mesh, differentiable=True)
        reset_counts()
        secs, got = host_time(sharded_grad, step, local, acc)
        what = f"sharded gradient, {comm} on {backend}"
        launches = read_counts()
        expect_counts(launches, what, **kern)
        comm_calls = expect_calls(what, **calls)
        err = close_grad(got, want, *tol, what)
        recs[f"{comm}_{backend}"] = {
            "seconds": secs, "max_abs_err": err,
            "err_of_scale": scale_err(got, want), "launches": launches,
            "collectives": comm_calls}
        if comm == "grid":
            b12 = launches["vjp_pair"]
    return recs, b12


def sharded_checkpoint(mesh, state):
    """save_sharded / load_sharded on the one-rank group: the block
    shard_state gives back bitwise, the whole state bitwise without a mesh,
    and no collective but the barriers (no all-gather)."""
    local = psh.shard_state(state, mesh, pad_far=True)
    before = tracing.counters()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save_sharded(f"{d}/ck", mesh, local, step=7,
                          cfg=SimConfig(n=state.n))
        save_s = time.perf_counter() - t0
        back, step, _ = ckpt.load_sharded(f"{d}/ck", mesh, pad_far=True)
        whole, _, cfg_d = ckpt.load_sharded(f"{d}/ck", device=DEV)
    made = {k: v for k, v in (tracing.counters() - before).items()
            if k.startswith("comm.")}
    if made:
        fail(f"sharded checkpoint: collectives {made}")
    for got, want, what in ((back, local, "the block"),
                            (whole, state, "the whole state")):
        if not all(torch.equal(getattr(got, f), getattr(want, f))
                   for f in ("pos", "vel", "mass")):
            fail(f"sharded checkpoint: {what} is not bitwise the saved one")
    if step != 7 or cfg_d["n"] != state.n:
        fail(f"sharded checkpoint: step {step}, config {cfg_d}")
    return {"n": state.n, "save_s": save_s, "bitwise": True,
            "collectives": "none"}


def sharded_ensemble(mesh):
    """examples/parameter_sweep.py's defaults through simulate_ensemble with
    mesh=make_mesh((1,)): bitwise the unsharded run, one gather."""
    st, _, cfg = sweep_case()
    t, c = sm.ensemble_tiling(SWEEP_N, None, kernel=True)
    want = simulate_ensemble(cfg, st)
    reset_counts()
    secs, got = host_time(simulate_ensemble, cfg, st, None, mesh)
    expect_counts(read_counts(), "sharded ensemble", slot_ensemble=(
        SWEEP_STEPS + 1) * per_call(tri_slots(c, t), SWEEP_B))
    calls = expect_calls("sharded ensemble", all_gather=1)
    if not (torch.equal(got.pos, want.pos) and torch.equal(got.vel,
                                                           want.vel)):
        fail("sharded ensemble: not bitwise the unsharded run")
    return {"b": SWEEP_B, "n": SWEEP_N, "steps": SWEEP_STEPS,
            "seconds": secs, "collectives": calls, "bitwise": True}


# ------------------------------------------------ band traversal (B16)

#: B16 against its plain version in bf16 mode, per column: the bf16 class,
#: |err| <= BAND_RTOL |want| + BAND_ATOL max|want[:, col]|
#: (tests/test_slot_pipe.py:24). Both round w and v to bf16; FMA contraction
#: in the kernel can move a w across a bf16 rounding boundary, and the
#: tensor cores add in another order.
BAND_RTOL, BAND_ATOL = SYM_RTOL, SYM_ATOL
#: Tile-level cases of band_vs_plain: (blocks per chunk, pad rows in the
#: last chunk): one block, odd with a ragged tail, even (the half-active
#: wrap band).
BAND_BLOCKS = ((1, 0), (5, 37), (6, 0))


def band_calls(c, tile, cross, n_sys=1):
    """Launches of one B16 call over n_sys chunks of c rows
    (sym_mxu_force._band_kernel): one per piece and group of systems."""
    pieces, group, _ = sm.band_launches(c // tile, cross, n_sys)
    return len(pieces) * -(-n_sys // group)


def band_pass_launches(n, tile, passes=1):
    """(tri, cross) B16 launches of ``passes`` band passes over n bodies at
    CHUNK."""
    tile, c, nc, _ = sm._resolve_tiling(n, tile, CHUNK, kernel=True)
    return (passes * nc * band_calls(c, tile, False),
            passes * nc * (nc - 1) // 2 * band_calls(c, tile, True))


def band_partial_tiles(nb, cross):
    """Column partials a call stores: every tile off a self chunk's
    diagonal (the wrap band half), every tile of a chunk pair."""
    return nb * nb if cross else nb * (nb - 1) // 2


def band_bound(c, tile, cross, n_sys=1):
    """B16's bound per call, counted as K2's: 12 fp32 and 32 bf16
    operations and one rsqrt per unordered pair; bytes: pos and v in, rows
    and cols out, and the column partials written and read once."""
    pairs = n_sys * (float(c) * c if cross else c * (c - 1) / 2)
    io = n_sys * c * (3 + 8 + 8 + 8) * 4.0 * (2 if cross else 1)
    part = n_sys * band_partial_tiles(c // tile, cross) * tile * 8 * 4.0 * 2
    return bound(pairs * OPS_K2_FP32, io + part, pairs * OPS_K2_MMA, pairs)


def band_sums(mode, p, v, c, tile, soft, split_w=False, mask=True, n_sys=1,
              plain=False):
    """One B16 call on packed bodies, or its plain version in bf16 mode:
    'tri' on rows [0, c), 'ensemble' on n_sys systems of c rows from row 0,
    'cross' on the chunk pair ([0, c), [c, 2c)). Returns the rows then the
    cols, stacked ((2 c, 8) in cross mode, the rows of a then the cols of
    b)."""
    rows_n = c * (2 if mode == "cross" else n_sys)
    rows = torch.zeros((rows_n, 8), device=p.device)
    cols = torch.zeros_like(rows)
    if mode == "cross":
        a, b = slice(0, c), slice(c, 2 * c)
        args = (rows[a], cols[b], p[a], p[b], v[a], v[b])
        if plain:
            sm._band_sums_plain(*args, tile, soft, split_w, mask, True,
                                torch.bfloat16)
        else:
            sm.band_cross_sums_(*args, tile, soft, split_w, mask)
        return torch.cat([rows[a], cols[b]])
    sl = slice(0, n_sys * c)
    if not plain:
        if mode == "tri":
            sm.band_tri_sums_(rows, cols, p[sl], v[sl], tile, soft, split_w,
                              mask)
        else:
            sm.band_tri_sums_ensemble_(rows, cols, p[sl], v[sl], tile, soft,
                                       n_sys, split_w, mask)
        return torch.cat([rows, cols])
    for s in range(n_sys):
        q = slice(s * c, (s + 1) * c)
        sm._band_sums_plain(rows[q], cols[q], p[q], p[q], v[q], v[q], tile,
                            soft, split_w, mask, False, torch.bfloat16)
    return torch.cat([rows, cols])


def close_band(got, want, what, real=None):
    """B16's raw sums against the plain version's, per column (BAND_RTOL,
    BAND_ATOL), on the rows ``real`` selects (the pad rows' sums are sliced
    off by the epilogue); returns (max abs error, median error over the
    column scale)."""
    if real is not None:
        got, want = got[real], want[real]
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    err = (got - want).abs()
    if (err > BAND_RTOL * want.abs() + BAND_ATOL * scale).any():
        fail(f"{what}: max err/col scale {(err / scale).max().item():.4g}")
    return err.max().item(), (err / scale).median().item()


def band_case(rng, n, np_, masses):
    """Packed (pos, v) of n uniform bodies padded to np_ rows."""
    pos = to_dev(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    m = to_dev(rng.uniform(0.5, 2.0, n).astype(np.float32)) if masses \
        else None
    return sm._pack(pos, m, n, np_)


def band_vs_plain_phase(rng):
    """B16 against its plain version (bf16 mode) in its three modes: tri
    chunks of 1, 5 (ragged tail) and 6 (even: the wrap band) blocks, the
    cross mode on a chunk pair whose second chunk is ragged, and the
    ensemble mode on 3 ragged systems; masked and maskless, unit masses and
    masses, split_w; each kernel call run twice, bitwise. Then one whole
    tri call at c = CHUNK with masses, timed beside its plain version."""
    errs, med, cases = [], [], 0
    for tile in (64, 128):
        for blocks, pads in BAND_BLOCKS:
            c = blocks * tile
            for masses, split_w, mask in ((False, False, True),
                                          (True, False, False),
                                          (True, True, True)):
                p, v = band_case(rng, c - pads, c, masses)
                what = (f"B16 tri tile={tile} nb={blocks} masses={masses} "
                        f"split_w={split_w} mask={mask}")
                args = ("tri", p, v, c, tile, 1e-9, split_w, mask)
                got = band_sums(*args)
                if not torch.equal(got, band_sums(*args)):
                    fail(f"{what}: two runs differ")
                real = torch.arange(2 * c, device=DEV) % c < c - pads
                e, m = close_band(got, band_sums(*args, plain=True), what,
                                  real)
                errs.append(e)
                med.append(m)
                cases += 1
        c = 4 * tile
        for masses, mask in ((False, True), (True, False)):
            p, v = band_case(rng, 2 * c - 37, 2 * c, masses)
            args = ("cross", p, v, c, tile, 1e-9, False, mask)
            got = band_sums(*args)
            if not torch.equal(got, band_sums(*args)):
                fail(f"B16 cross tile={tile}: two runs differ")
            e, m = close_band(got, band_sums(*args, plain=True),
                              f"B16 cross tile={tile} masses={masses}",
                              slice(0, 2 * c - 37))
            errs.append(e)
            med.append(m)
            cases += 1
        c, b = 5 * tile, 3
        pv = [band_case(rng, c - 37, c, True) for _ in range(b)]
        p, v = (torch.cat([x[k] for x in pv]) for k in (0, 1))
        args = ("ensemble", p, v, c, tile, 1e-9, False, True, b)
        got = band_sums(*args)
        if not torch.equal(got, band_sums(*args)):
            fail(f"B16 ensemble tile={tile}: two runs differ")
        real = torch.arange(2 * b * c, device=DEV) % c < c - 37
        e, m = close_band(got, band_sums(*args, plain=True),
                          f"B16 ensemble tile={tile}", real)
        errs.append(e)
        med.append(m)
        cases += 1
    # One whole tri call at the main path's chunk, with masses.
    tile = sm.DEFAULT_TILE
    p, v = band_case(rng, CHUNK, CHUNK, True)
    reset_counts()
    got = band_sums("tri", p, v, CHUNK, tile, 1e-9)
    launches = read_counts()
    expect_counts(launches, "band_vs_plain",
                  band_tri=band_calls(CHUNK, tile, False))
    plain_s, want = host_time(band_sums, "tri", p, v, CHUNK, tile, 1e-9,
                              False, True, 1, True)
    whole = close_band(got, want, f"B16 tri at c={CHUNK} with masses")
    line("band_vs_plain", cases=cases, rtol=BAND_RTOL, atol_of_col_scale=
         BAND_ATOL, max_abs_err=max(errs), median_err_of_col_scale=float(
             np.median(med)), bitwise_reruns=cases, whole_tri_c=CHUNK,
         whole_tri_max_abs_err=whole[0],
         whole_tri_median_err_of_col_scale=whole[1],
         whole_tri_plain_ms=plain_s * 1e3, whole_tri_launches=launches)


def band_main_phase(state, check):
    """simulate at N_MAIN on sym_mxu with traversal='band', 2 Euler steps
    from the main path's state: B16's tri and cross launches and no K2
    launch; the forces on the main path's rows against the fp64 oracle, the
    whole force against the slot traversal's at the bf16 class's bound,
    the step time beside main_path's K2 step. Returns (config, launches)."""
    idx, oracle, _, k2_2_steps_s = check
    cfg = SimConfig(n=N_MAIN, steps=2, backend="sym_mxu", traversal="band",
                    integrator="euler", sym_chunk=CHUNK)
    reset_counts()
    seconds, out = host_time(simulate, cfg, state)
    launches = read_counts()
    tri, cross = band_pass_launches(N_MAIN, sm.DEFAULT_TILE, 2)
    expect_counts(launches, "band_main_path", band_tri=tri, band_cross=cross)
    for t in (out.pos, out.vel):
        if t.shape != (N_MAIN, 3) or not torch.isfinite(t).all():
            fail("band: non-finite or misshapen state")
    f_band = make_force_fn(cfg)(state.pos, state.pos)
    f_slots = make_force_fn(cfg.replace(traversal="slots"))(state.pos,
                                                            state.pos)
    close(f_band[idx], oracle, SYM_RTOL, SYM_ATOL, "band vs fp64 oracle")
    err = close(f_band, f_slots, SYM_RTOL, SYM_ATOL, "band vs slots")
    line("band_main_path", n=N_MAIN, chunk=CHUNK, tile=sm.DEFAULT_TILE,
         euler_2_steps_s=seconds, step_s=seconds / 2,
         k2_main_path_step_s=k2_2_steps_s / 2, launches=launches,
         band_vs_fp64=rel_err_stats(f_band[idx], oracle),
         band_vs_slots_max_abs_err=err,
         band_vs_slots_max_err_of_scale=scale_err(f_band, f_slots),
         band_vs_slots=rel_err_stats(f_band, f_slots.double()))
    return cfg, launches


def config3_band_phase():
    """BASELINE config 3 on the band: plummer with masses, N = 262,144,
    softening 1e-2, dt 1e-3, 1000 leapfrog steps on sym_mxu with
    traversal='band' (B16), E0 and E1 through K4; fails above the drift
    gate."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    state = init.plummer(N_CONFIG3, generator=gen, device=DEV)
    cfg = SimConfig(n=N_CONFIG3, steps=STEPS_CONFIG3, dt=1e-3,
                    softening=1e-2, integrator="leapfrog", use_masses=True,
                    backend="sym_mxu", traversal="band")
    probe_s, _ = host_time(simulate, cfg, state, 1)
    estimate_s = probe_s * (STEPS_CONFIG3 + 1) / 2
    if estimate_s > CONFIG3_MAX_S:
        fail(f"config3_band: one step took {probe_s:.3f} s, so "
             f"{STEPS_CONFIG3} steps would take ~{estimate_s:.0f} s")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0 = dg.total_energy(state, cfg.softening)
    out = simulate(cfg, state)
    e1 = dg.total_energy(out, cfg.softening)
    drift = dg.energy_drift(e0, e1).item()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    tri, cross = band_pass_launches(N_CONFIG3, sm.DEFAULT_TILE,
                                    STEPS_CONFIG3 + 1)
    expect_counts(launches, "config3_band_drift", band_tri=tri,
                  band_cross=cross, pe=2)
    dg.assert_finite(out, "after config 3 on the band")
    if not drift <= DRIFT_GATE:
        fail(f"config3_band: energy drift {drift:.3g} > {DRIFT_GATE}")
    line("config3_band_drift", n=N_CONFIG3, steps=STEPS_CONFIG3,
         drift=drift, e0=e0.item(), e1=e1.item(), launches=launches,
         seconds=seconds, one_step_probe_s=probe_s,
         momentum_after=dg.momentum(out).tolist())


def band_ensemble_phase():
    """body_force_sym_mxu_ensemble with traversal='band' (B16's ensemble
    mode) on examples/parameter_sweep.py's systems (32 x 1024) and on
    ENS_B plummer systems of ENS_N with masses (ensemble_fp32's): exact
    launch counts, every system bitwise its standalone band call at the
    ensemble's tile and chunk, the distance from B9a's slot result on the
    same systems. The larger call's raw sums are held against the plain
    version (bf16 mode) system by system and timed. Returns B16's ensemble
    record."""
    st, _, _ = sweep_case()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    systems = [init.plummer(ENS_N, generator=gen, device=DEV)
               for _ in range(ENS_B)]
    cases = {"sweep": (st.pos, st.mass, SWEEP_SOFT),
             "masses": (torch.stack([s.pos for s in systems]),
                        torch.stack([s.mass for s in systems]), 1e-2)}
    out = {}
    for name, (pos, mass, soft) in cases.items():
        b, n = pos.shape[:2]
        t, c = sm.ensemble_tiling(n, None, kernel=True)
        reset_counts()
        seconds, f = host_time(sm.body_force_sym_mxu_ensemble, pos, mass,
                               soft, None, False, "auto", "band")
        launches = read_counts()
        expect_counts(launches, f"band_ensemble {name}",
                      band_ensemble=band_calls(c, t, False, b))
        for i in range(b):
            alone = sm.body_force_sym_mxu(pos[i], mass[i], soft, tile=t,
                                          chunk=c, traversal="band")
            if not torch.equal(f[i], alone):
                fail(f"band_ensemble {name}: system {i} is not bitwise its "
                     "standalone band call")
        slots = sm.body_force_sym_mxu_ensemble(pos, mass, soft)
        err = close(f, slots, SYM_RTOL, SYM_ATOL, f"band_ensemble {name} "
                    "vs the slots (B9a)")
        out[name] = {"b": b, "n": n, "tile": t, "chunk": c,
                     "seconds": seconds, "launches": launches,
                     "bitwise_systems": b, "vs_b9a_max_abs_err": err,
                     "vs_b9a_max_err_of_scale": scale_err(f, slots)}
    pos, mass, soft = cases["masses"]
    b, n = pos.shape[:2]
    t, c = sm.ensemble_tiling(n, None, kernel=True)
    p, v = sm.pack_ensemble(pos, mass, c, sm._pack)
    args = ("ensemble", p, v, c, t, soft, False, True, b)
    ms = time_fn(band_sums, *args, reps=3) * 1e3
    got = band_sums(*args)
    plain_s, want = host_time(band_sums, *args, True)
    real = torch.arange(2 * b * c, device=DEV) % c < n
    err, med = close_band(got, want, f"B16 ensemble at B={b} N={n}", real)
    per = band_calls(c, t, False, b)
    red = band_reduce_ms(c, t, False, b)
    line("band_ensemble", cases=out, kernel_ms=ms, plain_ms=plain_s * 1e3,
         raw_sums_max_abs_err=err, raw_sums_median_err_of_col_scale=med)
    return slot_entry("band_mxu ensemble mode (B16)", "band_mxu.cu",
                      "sym_mxu_force.py:368", out["masses"]["launches"]
                      ["band_ensemble"], err, ms, red, per, plain_s * 1e3,
                      band_bound(c, t, False, b), b=b, n=n, tile=t,
                      masses=True)


def band_reduce_ms(c, tile, cross, n_sys=1):
    """CUDA-event ms of the slot_reduce launches of one B16 call: each
    piece's plan over scratch of whatever it holds."""
    nb = c // tile
    steps = sm.band_steps(nb, cross)
    pieces, group, longest = sm.band_launches(nb, cross, n_sys)
    part = torch.empty(group * longest * tile * 8, device=DEV)
    cols = torch.zeros((n_sys * c, 8), device=DEV)
    lib = _build.load_library()
    stream = _build.stream_ptr(DEV)

    def run():
        for i0, i1 in pieces:
            tg, off, ent, order = sm._band_plan(nb, cross, i0, i1,
                                                str(DEV))
            for g0 in range(0, n_sys, group):
                g = min(group, n_sys - g0)
                _build.check(lib, lib.slot_reduce_launch(
                    part.data_ptr(), tile * 8, tg.shape[0], tg.data_ptr(),
                    off.data_ptr(), ent.data_ptr(), order.data_ptr(),
                    cols[g0 * c:].data_ptr(), cols[g0 * c:].data_ptr(), g,
                    c * 8, (i1 - i0) * steps, stream), "slot_reduce_launch")

    return time_fn(run, reps=3) * 1e3


def time_band(state, launches, cfg_band):
    """One B16 tri call (chunk 0) and one cross call (chunks 0, 1) at the
    band path's chunk and tile, unit masses, masked as the path runs them,
    each beside its plain version (bf16 mode) and held to it; a whole band
    pass at N_MAIN. Returns the tri and cross records."""
    soft = cfg_band.softening
    tile, c, nc, np_ = sm._resolve_tiling(N_MAIN, sm.DEFAULT_TILE, CHUNK,
                                          kernel=True)
    p, v = sm._pack(state.pos, None, N_MAIN, np_)
    rec = {}
    for mode in ("tri", "cross"):
        call_s = time_fn(band_sums, mode, p, v, c, tile, soft, reps=3)
        got = band_sums(mode, p, v, c, tile, soft)
        plain_s, want = host_time(band_sums, mode, p, v, c, tile, soft,
                                  False, True, 1, True)
        err, med = close_band(got, want, f"B16 {mode} at c={c}")
        del want
        rec[mode] = (call_s * 1e3, plain_s * 1e3, err, med,
                     band_reduce_ms(c, tile, mode == "cross"))
    pass_s = time_fn(make_force_fn(cfg_band), state.pos, state.pos, reps=2)
    body = body_info("B16")
    line("time_band", n=N_MAIN, chunk=c, tile=tile,
         calls={m: {"call_ms": r[0], "plain_ms": r[1], "max_abs_err": r[2],
                    "median_err_of_col_scale": r[3], "slot_reduce_ms": r[4]}
                for m, r in rec.items()},
         pass_ms=pass_s * 1e3, pass_ginter_s=gips(N_MAIN, pass_s), body=body)
    out = []
    for mode, line_no in (("tri", 226), ("cross", 267)):
        call_ms, plain_ms, err, _, red = rec[mode]
        cross = mode == "cross"
        out.append(slot_entry(
            f"band_mxu {mode} mode (B16)", "band_mxu.cu",
            f"sym_mxu_force.py:{line_no}", launches[f"band_{mode}"], err,
            call_ms, red, band_calls(c, tile, cross), plain_ms,
            band_bound(c, tile, cross), chunk=c,
            pass_ms_n_2_20=pass_s * 1e3, body=body))
    return out


def cli_json(argv):
    """Run nbody-torch in this process: (its stdout lines as JSON, its exit
    code)."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main([*argv, "--device", DEV.type])
        except SystemExit as e:
            code = e.code
    return [json.loads(x) for x in buf.getvalue().splitlines() if x], code


def cli_check_phase():
    """nbody-torch check on sym (uniform) and on sym_mxu (plummer,
    softening 1e-2) at N_CLI_CHECK: JAX's gates, exit code 0."""
    t0 = time.perf_counter()
    runs = []
    for backend, extra in (("sym", []),
                           ("sym_mxu", ["--init", "plummer", "--softening",
                                        "1e-2"])):
        out, code = cli_json(["check", "--n", str(N_CLI_CHECK), "--backend",
                              backend, *extra])
        rep = out[-1]
        if code != 0 or not rep["ok"] or rep["backend"] != backend:
            fail(f"cli check on {backend}: exit {code}, {rep}")
        runs.append(rep)
    line("cli_check", n=N_CLI_CHECK, runs=runs,
         seconds=time.perf_counter() - t0)


def cli_run_resume_phase():
    """nbody-torch run: CLI_RUN_STEPS Euler steps saved, then as many
    resumed from the checkpoint; the final checkpoint bitwise a 2 x
    CLI_RUN_STEPS-step simulate of the same seed."""
    t0 = time.perf_counter()
    n, k = N_CLI_RUN, CLI_RUN_STEPS
    with tempfile.TemporaryDirectory() as d:
        common = ["run", "--n", str(n), "--steps", str(k)]
        (first,), c1 = cli_json([*common, "--save", f"{d}/a"])
        (second,), c2 = cli_json([*common, "--resume", f"{d}/a", "--save",
                                  f"{d}/b"])
        got, step, _ = ckpt.load(f"{d}/b", device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    want = simulate(SimConfig(n=n, steps=2 * k),
                    init.uniform_random(n, generator=gen, device=DEV))
    if c1 or c2 or step != 2 * k:
        fail(f"cli run/resume: exits {c1}, {c2}, step {step}")
    if not (torch.equal(got.pos, want.pos) and torch.equal(got.vel,
                                                           want.vel)):
        fail("cli run/resume: not bitwise the 20-step simulate")
    line("cli_run_resume", n=n, steps=[k, k], bitwise_simulate=2 * k,
         wall_s=[first["wall_s"], second["wall_s"]],
         seconds=time.perf_counter() - t0)


def cli_bench_phase():
    """nbody-torch bench at N_MAIN on each of CLI_BENCH's backends, --reps
    2: each roofline_frac in (0, 1], beside the expected one."""
    t0 = time.perf_counter()
    runs = []
    for argv, expected in CLI_BENCH:
        (rep,), code = cli_json(["bench", "--n", str(N_MAIN), *argv,
                                 "--reps", "2"])
        frac = rep["roofline_frac"]
        if code or not 0 < frac <= 1:
            fail(f"cli bench {argv}: exit {code}, roofline_frac {frac}")
        runs.append({**rep, "roofline_frac_expected": expected})
    line("cli_bench", runs=runs, seconds=time.perf_counter() - t0)
    return runs


def cli_shmoo_phase():
    """nbody-torch shmoo over CLI_SHMOO_SIZES on auto: the 4096 row is
    sym_resident (B15), every roofline_frac in (0, 1]."""
    t0 = time.perf_counter()
    rows, code = cli_json(["shmoo", "--sizes",
                           ",".join(map(str, CLI_SHMOO_SIZES)),
                           "--backend", "auto", "--format", "jsonl"])
    if code or [r["n"] for r in rows] != list(CLI_SHMOO_SIZES):
        fail(f"cli shmoo: exit {code}, rows {rows}")
    if rows[0]["backend"] != "sym_resident":
        fail(f"cli shmoo: the 4096 row ran {rows[0]['backend']}")
    if not all(0 < r["roofline_frac"] <= 1 for r in rows):
        fail(f"cli shmoo: roofline_frac outside (0, 1]: {rows}")
    line("cli_shmoo", rows=rows, seconds=time.perf_counter() - t0)


def cli_tune_phase():
    """nbody-torch tune at N_CLI_TUNE on sym with the cache in a temporary
    directory, then run --autotune, which must read the cache back (the
    tuner's measurement is replaced by one that fails)."""
    t0 = time.perf_counter()
    saved_env = os.environ.get(autotune.CACHE_ENV)
    saved_measure = autotune._default_measure

    def refuse(*_):
        fail("run --autotune measured again instead of reading the cache")

    with tempfile.TemporaryDirectory() as d:
        os.environ[autotune.CACHE_ENV] = f"{d}/autotune.json"
        try:
            (rep,), code = cli_json(["tune", "--n", str(N_CLI_TUNE),
                                     "--backend", "sym"])
            cache = json.loads(Path(f"{d}/autotune.json").read_text())
            autotune._default_measure = refuse
            _, run_code = cli_json(["run", "--n", str(N_CLI_TUNE),
                                    "--backend", "sym", "--steps", "2",
                                    "--autotune"])
            applied = autotune.tune(SimConfig(n=N_CLI_TUNE, backend="sym"),
                                    device=DEV)
        finally:
            autotune._default_measure = saved_measure
            if saved_env is None:
                os.environ.pop(autotune.CACHE_ENV, None)
            else:
                os.environ[autotune.CACHE_ENV] = saved_env
    (key, entry_), = cache.items()
    if code or run_code or entry_["params"]["sym_tile"] != rep["sym_tile"] \
            or applied.sym_tile != rep["sym_tile"]:
        fail(f"cli tune: exits {code}, {run_code}; {rep}; {entry_}")
    line("cli_tune", key=key, best=rep, results=entry_["results"],
         ginter_s=entry_["ginter_s"], read_back=True,
         seconds=time.perf_counter() - t0)


def trace_phase():
    """2 steps at N_TRACE on auto under utils/tracing.profile_trace, each
    in an annotate span: the Chrome trace holds the span, one nbody.force
    span a step and K3's kernel. Also reports whether annotate's gate is
    on under emit_nvtx(), where Nsight would record its ranges."""
    t0 = time.perf_counter()
    cfg = SimConfig(n=N_TRACE)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    state = init.uniform_random(N_TRACE, generator=gen, device=DEV)
    step = tsim.make_step_fn(cfg)
    carry = init_carry(cfg, state)
    step(carry)  # warm: first-use costs stay out of the trace
    with tempfile.TemporaryDirectory() as d:
        with tracing.profile_trace(d, device=DEV) as prof:
            for _ in range(2):
                with tracing.annotate("nbody_step"):
                    carry = step(carry)
            torch.cuda.synchronize()
        events = json.loads(
            (Path(d) / tracing.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    k3 = [k for k in kernels if "symmetric_force_kernel" in k]
    forces = sum(e.get("cat") == "user_annotation"
                 and e.get("name") == "nbody.force" for e in events)
    if "nbody_step" not in names or not k3 or forces != 2:
        fail(f"trace: span found {'nbody_step' in names}, nbody.force spans "
             f"{forces}, kernels {kernels[:8]}")
    with torch.autograd.profiler.emit_nvtx():
        nvtx_gate = tracing._profiler_enabled()
    top = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)
    line("trace", n=N_TRACE, steps=2, span="nbody_step", force_spans=forces,
         gate_under_emit_nvtx=nvtx_gate, kernels=len(kernels),
         k3_events=sum(e.get("name") in k3 for e in events),
         top_device_us={a.key[:60]: a.self_device_time_total
                        for a in top[:4]},
         seconds=time.perf_counter() - t0)


def examples_phase():
    """Each examples/torch script in this process on the card (EXAMPLES'
    arguments; multihost_cpu spawns its own gloo ranks on the CPU); its
    last line of output is kept."""
    import importlib.util

    t0 = time.perf_counter()
    runs = {}
    for name, argv in EXAMPLES:
        path = Path(__file__).resolve().parent / "examples" / "torch" / \
            f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"ex_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = (mod.main(argv) if argv is not None
                  else mod.main(2) if name == "multihost_cpu"
                  else mod.main())
        if rc:
            fail(f"example {name}: returned {rc}")
        runs[name] = {"last": (buf.getvalue().splitlines() or [""])[-1],
                      "seconds": time.perf_counter() - t1}
    line("examples", runs=runs, seconds=time.perf_counter() - t0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--bwd-tile", type=int, choices=SYM_BWD_TILES,
        help="tile of the pair-once backwards B11 and B13 on every path "
             f"(default: theirs, {vk.DEFAULT_TILE} and {vm.DEFAULT_TILE})")
    args = parser.parse_args(argv)
    if args.bwd_tile is not None:
        vk.DEFAULT_TILE = vm.DEFAULT_TILE = args.bwd_tile
    smi = device_phase()
    build_phase()
    rng = np.random.default_rng(SEED)
    k1_phase(rng)
    k2_phase(rng)
    k3_phase(rng)
    k4_phase(rng)
    b6_phase(rng)
    b4_phase(rng)
    band_vs_plain_phase(rng)
    state, launches, k1_err, cfg_sym, cfg_dir, check = main_phase()
    cfg_auto, auto_launches = auto_phase(state, check)
    mxu_pass_s = mxu_main_phase(state, check)
    cfg_band, band_launches = band_main_phase(state, check)
    leapfrog_phase()
    state3, c3_launches = config3_phase()
    _, c3_mxu_launches = config3_mxu_phase()
    config3_band_phase()
    state2, c2_launches = config2_phase()
    vjp_phase(rng)
    *config3, b10 = grad_config3_phase(rng)
    *sym, b11 = grad_sym_phase(rng)
    mxu_records = grad_sym_mxu_phase(rng, sym, config3)
    grad_mxu_phase(sym)
    b4 = pair_mxu_phase(state3)
    determinism_phase(rng)
    b9a = ensemble_sweep_phase()
    b9b = ensemble_fp32_phase()
    b16_ensemble = band_ensemble_phase()
    trajectory_phase()
    coincident_gate_phase(rng)
    b9cd = grad_ensemble_phase()
    _, b12 = b12_phase(rng)
    b12["launches"] = sharded_phase()
    b15 = resident_phase()
    resident_crossover_phase()
    kernels = (times_phase(state, launches, k1_err, cfg_sym, cfg_dir)
               + time_k3(state, auto_launches, cfg_auto)
               + time_k4(state3, state, c3_launches)
               + time_k5(state2, c2_launches) + [b10, b11] + mxu_records
               + [time_b6(state3, c3_mxu_launches, mxu_pass_s), b4, b9a,
                  b9b] + b9cd + b15 + [b12]
               + time_band(state, band_launches, cfg_band) + [b16_ensemble])
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']} was never launched on its path")
    cli_check_phase()
    cli_run_resume_phase()
    cli_bench_phase()
    cli_shmoo_phase()
    cli_tune_phase()
    trace_phase()
    examples_phase()
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
