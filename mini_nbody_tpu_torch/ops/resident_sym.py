"""The resident trajectory: a whole run of Euler steps, or of leapfrog or
Yoshida-4 steps, in one launch, the state kept on the card (B15).

Counterpart of ``mini_nbody_tpu/ops/resident_sym.py`` (``:557-664``
simulate_resident_sym, ``:667-692`` auto_tile_ensemble, ``:695-806``
simulate_resident_sym_ensemble, ``:809-866`` the ensemble leapfrog and
its class force, ``:868-898`` the leapfrog, ``:901-927`` y4_cycle,
``:930-994`` the Yoshida-4 drivers).

CUDA tensors launch ``csrc/resident_sym.cu`` once per call: a cooperative
kernel that copies the bodies into its padded state, then, every force
pass, runs the streamed pair-once slot bodies (K3's in the fp32 class,
``mxu=False``; K2's in the bf16 class, ``mxu=True``) over the tri slot list
in pieces of ``slot_pipe.PIECE_SLOTS`` slots, adds each block's partials
in slot order and integrates in place (the last piece's sums added by the
integrating thread itself), with grid barriers between the phases, and
writes the real bodies out after the last pass. CPU tensors take
``resident_plain``, the same schedule in PyTorch: per pass, each piece's
per-slot partials, the slot-order sums (``slot_pipe.slot_reduce_plain``
for every piece but the last, the integrate's own sums for the last), then
the same integrate.

Leapfrog and Yoshida-4 run in the same launch: between two force passes a
KDK step is one substep of the kernel's (kick_a, kick_b, drift) form, so
``simulate_resident_sym_kdk`` runs an opening pass (half-kick and drift),
steps - 1 leapfrog substeps (every substep (dt / 2, dt / 2, dt)) or
3 steps - 1 Yoshida-4 substeps (``y4_cycle``), and a closing pass
(half-kick, no drift): the force passes of the streamed loop. The two
half-kicks stay unmerged, as the streamed loop adds them, so at the same
tile and slot list a resident Euler, leapfrog or Yoshida-4 run is bitwise
the streamed run (JAX merges the leapfrog kicks, and runs its end passes
outside the kernel).

Not carried over: the v5e VMEM admission and rate tables (``_MAX_NB``,
``_MAX_NB_FP32_MASS``, ``_TILE_RATE``) and the v5e fold policy
(``_fold_auto``). The kernel's tiles are RESIDENT_TILES (64 and 128, as
K2's and K3's); the
default tile is the one that pads less (ties 128), and the fold default
``FOLD_DEFAULT`` is the card's measurement. The cap RESIDENT_SYM_MAX_N is
the API's: an ensemble is capped on its stacked B Np.

Deliberate split from the reference (ROADMAP C4): every pair that touches a
pad body has w = 0, whatever ``coincident`` says, and so do self pairs; in
JAX a 'fast' fold gives FAR-vs-FAR pad pairs softening^-1.5 weights that
integrate every step. Real bodies keep JAX's 'fast' semantics (only the
off-diagonal d2 == 0 mask is dropped). 'auto' is 'masked': a trajectory can
form a duplicate at any step, which no scan at t = 0 rules out.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.ops import slot_pipe
from mini_nbody_tpu_torch.ops.integrators import _Y4_W0, _Y4_W1
from mini_nbody_tpu_torch.ops.slot_pipe import SLOT_CROSS, SLOT_DIAG, SLOT_FOLD
from mini_nbody_tpu_torch.ops.slot_pipe import _w_fold_block
from mini_nbody_tpu_torch.ops.sym_mxu_force import (_pack, _w_block,
                                                    check_ensemble,
                                                    ensemble_tiling)
from mini_nbody_tpu_torch.ops.symmetric_force import _sums
from mini_nbody_tpu_torch.utils.config import (FAR, RESIDENT_TILES,
                                               SOFTENING, check_coincident,
                                               fast_rsqrt_cube,
                                               plain_block_elems, round_up)
from mini_nbody_tpu_torch.utils.tracing import count

#: The most bodies one resident launch holds: N for one system, B Np for an
#: ensemble (the JAX package's cap; 32 B of state per body, 4 MB here).
RESIDENT_SYM_MAX_N = 131072

#: Whether the tri slot list folds diagonal block pairs when the caller
#: names no fold. chip_smoke.py's resident_crossover phase (NVIDIA H100 80GB
#: HBM3, 700 W) timed B15 with fold on and off, eight runs: the fold is
#: slower per step at every size, for one system by 5-8% at 16,384 and
#: 32,768 and by up to 44% (fp32 at N = 4096: each fold slot runs its two
#: passes in a row, on the pass's longest path), for ensembles by up to 61%
#: (256 systems of 256). It stays on: with the streamed kernels' slot list,
#: B15's runs are bitwise the streamed runs, so routing a run to B15
#: changes no bit of its result.
FOLD_DEFAULT = True


def auto_tile(n: int, kernel: bool = True) -> int:
    """The default tile of one system of n bodies, in both classes and mass
    modes (the card kernel's tiles carry no VMEM admission): on the card
    the kernel tile that pads less, ties 128 (ensemble_tiling); on the CPU
    128, shrunk to the problem as the plain paths shrink it."""
    return ensemble_tiling(n, None, kernel)[0]


def auto_tile_ensemble(b: int, n: int, kernel: bool = True) -> int:
    """auto_tile for B systems, which must fit the cap on their stacked
    padded rows; raises ValueError when they do not."""
    t = auto_tile(n, kernel)
    if b * round_up(n, t) > RESIDENT_SYM_MAX_N:
        raise ValueError(
            f"no admissible resident tile for B={b}, N={n}: B*Np = "
            f"{b * round_up(n, t)} > {RESIDENT_SYM_MAX_N}; use the streamed "
            "ensemble (sim.simulate_ensemble routes there)")
    return t


def y4_cycle(dt: float):
    """The (kick_a, kick_b, drift) 3-cycle of the fused Yoshida-4 substeps
    and the opening and closing half-step h1 (JAX's derivation: substep k
    closes the previous leapfrog with kick h_prev / 2 and opens the next
    with h_next / 2, unmerged, then drifts h_next; (h_prev, h_next) cycles
    (h1, h0), (h0, h1), (h1, h1)). Python floats computed as the streamed
    path computes them (0.5 * (w * dt))."""
    h1 = _Y4_W1 * dt
    h0 = _Y4_W0 * dt
    cycle = ((0.5 * h1, 0.5 * h0, h0),
             (0.5 * h0, 0.5 * h1, h1),
             (0.5 * h1, 0.5 * h1, h1))
    return cycle, h1


# ------------------------------------------------------------- plan ---

#: The kernel plans of the live slot tables: id(table) -> {PIECE_SLOTS:
#: plan}, each entry dropped with its table.
_PLANS: dict[int, dict] = {}


def resident_plan(slots: torch.Tensor):
    """The kernel's reduction plan of a tri slot table, on its device, from
    slot_pipe.plan_pieces: (pieces (P, 4) [first slot, slots, first target,
    end target], targets (., 3) [block, first entry, end entry], entries,
    last_target (nb,) [each block's target in the last piece, or -1],
    largest piece), built once per table and PIECE_SLOTS."""
    key = id(slots)
    if key not in _PLANS:
        _PLANS[key] = {}
        weakref.finalize(slots, _PLANS.pop, key, None)
    plans = _PLANS[key]
    if slot_pipe.PIECE_SLOTS not in plans:
        rows = slots.cpu().numpy()
        pieces, targets, entries = [], [], []
        n_entries = 0
        for s0, n, tgt, offsets, ent in slot_pipe.plan_pieces(rows, True):
            t0 = sum(len(t) for t in targets)
            pieces.append((s0, n, t0, t0 + len(tgt)))
            targets.append(np.stack([tgt >> 1, offsets[:-1] + n_entries,
                                     offsets[1:] + n_entries], axis=1))
            entries.append(ent)
            n_entries += ent.shape[0]
        last_target = np.full(int(rows[:, 1:].max()) + 1, -1)
        t0, t1 = pieces[-1][2:]
        last_target[targets[-1][:, 0]] = np.arange(t0, t1)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a).astype(
                np.int32)).to(slots.device)

        plans[slot_pipe.PIECE_SLOTS] = (
            dev(np.asarray(pieces).reshape(-1, 4)),
            dev(np.concatenate(targets).reshape(-1, 3)),
            dev(np.concatenate(entries)), dev(last_target),
            max(p[1] for p in pieces))
    return plans[slot_pipe.PIECE_SLOTS]


# ------------------------------------------------------------ plain ---

def _pad_mask(bi, bj, tile, n_real, fold, device):
    """(S, T, T) True where pair (r, c) of each slot touches a pad: rows in
    block bi and columns in bj, a fold's upper triangle both in bj and its
    lower both in bi (slot_body.cuh pad_pair)."""
    idx = torch.arange(tile, device=device)
    rows = bi[:, None] * tile + idx  # (S, T)
    cols = bj[:, None] * tile + idx
    if not fold:
        return (rows >= n_real)[:, :, None] | (cols >= n_real)[:, None, :]
    upper = idx[None, :] > idx[:, None]  # [r, c]: c > r
    pad_a = (rows >= n_real)[:, :, None] | (rows >= n_real)[:, None, :]
    pad_b = (cols >= n_real)[:, :, None] | (cols >= n_real)[:, None, :]
    return torch.where(upper, pad_b, pad_a)


def _fp32_partials(kind, pa, pb, pad, softening, fast):
    """K3's two partial tiles (S, 2, T, 3) of a batch of slots of one kind:
    blocks pa (rows) and pb (columns), pad pairs zeroed."""
    tile = pa.shape[1]
    idx = torch.arange(tile, device=pa.device)
    lower = idx[None, :] < idx[:, None]  # [r, c]: c < r
    if kind == SLOT_FOLD:
        d = [torch.where(lower, pa[:, None, :, k] - pa[:, :, None, k],
                         pb[:, None, :, k] - pb[:, :, None, k])
             for k in range(3)]
    else:
        d = [pb[:, None, :, k] - pa[:, :, None, k] for k in range(3)]
    dx, dy, dz = d
    r2 = dx * dx + dy * dy + (dz * dz + softening)
    if fast:
        w = torch.rsqrt((r2 * r2) * r2)
    else:
        inv = torch.rsqrt(r2)
        w = (inv * inv) * inv
    w = torch.where(pad, torch.zeros_like(w), w)
    t = [dk * w for dk in d]
    out = pa.new_zeros((pa.shape[0], 2, tile, 3))
    if kind != SLOT_FOLD:
        rows, cols = _sums(t, pa, pb)
        out[:, 0] = rows
        if kind == SLOT_CROSS:
            out[:, 1] = -cols
        return out
    t_lo = [torch.where(lower, tk, torch.zeros_like(tk)) for tk in t]
    t_hi = [tk - lo for tk, lo in zip(t, t_lo)]
    rows, cols = _sums(t_lo, pa, pa)
    out[:, 0] = rows - cols
    rows, cols = _sums(t_hi, pb, pb)
    out[:, 1] = rows - cols
    return out


def _mxu_partials(kind, pa, pb, va, vb, pad, softening, fast, mask_offdiag,
                  mma_dtype):
    """K2's two partial tiles (S, 2, T, 8) of a batch of slots of one kind:
    positions pa / pb, operands va / vb (S, T, 8), pad pairs zeroed."""
    mm = slot_pipe._mm
    zero = torch.zeros((), device=pa.device)
    out = pa.new_zeros((pa.shape[0], 2, pa.shape[1], 8))
    if kind == SLOT_FOLD:
        w_lo, w_hi = _w_fold_block(pa, pb, softening, fast, mask_offdiag)
        w_lo, w_hi = (torch.where(pad, zero, w) for w in (w_lo, w_hi))
        out[:, 0] = (mm((w_lo,), va, False, mma_dtype)
                     + mm((w_lo,), va, True, mma_dtype))
        out[:, 1] = (mm((w_hi,), vb, False, mma_dtype)
                     + mm((w_hi,), vb, True, mma_dtype))
        return out
    w = _w_block(pa, pb, softening, fast,
                 mask=kind == SLOT_DIAG or mask_offdiag)
    w = torch.where(pad, zero, w)
    out[:, 0] = mm((w,), vb, False, mma_dtype)
    if kind == SLOT_CROSS:
        out[:, 1] = mm((w,), va, True, mma_dtype)
    return out


def _last_piece_plain(part, plan, acc, tile, width):
    """B15's fused reduce of the last piece, as the integrate sees it: acc
    plus each body's row of its block's partials (part: the piece's
    (2 slots, tile, width) tiles) summed in slot order, the sum added to
    the accumulator value as the streamed reduce adds it (0 + the sum in a
    one-piece pass); acc as it stands for a block that is no target of the
    last piece (resident_plan's last_target)."""
    _, targets, entries, last_target, _ = plan
    tiles = part.view(-1, tile, width)
    out = acc.clone()
    for blk, t in enumerate(last_target.tolist()):
        if t < 0:
            continue
        _, e0, e1 = targets[t].tolist()
        total = torch.zeros((tile, width), dtype=part.dtype,
                            device=part.device)
        for e in entries[e0:e1].tolist():
            total = total + tiles[e]
        rows = slice(blk * tile, (blk + 1) * tile)
        out[rows] = acc[rows] + total
    return out


def _force_plain(pos, mass, slots, tile, n_real, softening, mxu,
                 mask_offdiag, mma_dtype):
    """One system's (rows, 3|8) sums of one pass: per piece of the slot
    list the per-slot partials in batches of slots, then their sums in
    slot order, as B15 adds them: every piece but the last into the
    accumulator (slot_pipe.slot_reduce_plain), the last by
    _last_piece_plain."""
    width = 8 if mxu else 3
    fast = fast_rsqrt_cube(softening)
    acc = torch.zeros((pos.shape[0], width), dtype=torch.float32,
                      device=pos.device)
    p = pos if mxu or mass is None else torch.cat([pos, mass[:, None]], 1)
    blocks = p.view(-1, tile, p.shape[1])
    vblocks = None
    if mxu:  # K2's operand [m p | m], split into bf16 and its remainder
        rows = pos.shape[0]
        vblocks = _pack(pos, mass, rows, rows)[1].view(-1, tile, 8)
    batch = max(1, plain_block_elems(pos.device) // (tile * tile))
    table = slots.to(dtype=torch.long)
    pieces = slot_pipe.reduce_plan(slots, True)
    for i, plan in enumerate(pieces):
        s0, n = plan[:2]
        piece = table[s0:s0 + n]
        part = pos.new_zeros((n, 2, tile, width))
        for kind in (SLOT_DIAG, SLOT_CROSS, SLOT_FOLD):
            sel = torch.nonzero(piece[:, 0] == kind).flatten()
            for b0 in range(0, sel.shape[0], batch):
                at = sel[b0:b0 + batch]
                bi, bj = piece[at, 1], piece[at, 2]
                pad = _pad_mask(bi, bj, tile, n_real, kind == SLOT_FOLD,
                                pos.device)
                if mxu:
                    part[at] = _mxu_partials(
                        kind, blocks[bi], blocks[bj], vblocks[bi],
                        vblocks[bj], pad, softening, fast, mask_offdiag,
                        mma_dtype)
                else:
                    part[at] = _fp32_partials(kind, blocks[bi], blocks[bj],
                                              pad, softening, fast)
        if i + 1 == len(pieces):
            return _last_piece_plain(part, resident_plan(slots), acc, tile,
                                     width)
        slot_pipe.slot_reduce_plain(part.reshape(-1), plan, acc, acc, tile,
                                    width)


def _integrate_plain(pos, vel, acc, mxu, dt, coeffs):
    """The integrate of B15 on one system, in place: F from the sums, then
    an Euler step (coeffs None: v += dt F, x += dt v) or one pass's
    (kick_a, kick_b, drift): v += kick_a F, then v += kick_b F unless
    kick_b is None, then x += drift v unless drift is None."""
    if mxu:
        s = acc[:, 0:4] + acc[:, 4:8]
        f = s[:, 0:3] - pos * s[:, 3:4]
    else:
        f = acc
    ka, kb, h = (dt, None, dt) if coeffs is None else coeffs
    v = vel + ka * f
    if kb is not None:
        v = v + kb * f
    vel.copy_(v)
    if h is not None:
        pos.copy_(pos + h * vel)


def _pass_coeffs(steps, y4, y4_phase, ends):
    """Each force pass's integrate coefficients (_integrate_plain's
    coeffs): with ends (half, h1), the opening pass (half, None, h1)
    first and the closing pass (half, None, None) last; between them
    `steps` Euler steps (y4 None) or substeps of the cycle y4 from
    y4_phase."""
    inner = [None if y4 is None else y4[(step + y4_phase) % 3]
             for step in range(steps)]
    if ends is None:
        return inner
    half, h1 = ends
    return [(half, None, h1), *inner, (half, None, None)]


def resident_plain(pos, vel, mass, slots, tile, n_real, steps, dt,
                   softening, mxu, mask_offdiag, y4=None, y4_phase=0,
                   mma_dtype=torch.float32, ends=None):
    """Plain version of B15, in place on pos, vel (B, Np, 3) and mass
    (B, Np) or None: B15's schedule system by system, pass by pass (the
    forces of the whole pass, then the integrate): `steps` Euler steps or
    substeps of y4, and with ends (half, h1) an opening pass before them
    and a closing pass after (_pass_coeffs). mma_dtype as in slot_pipe's
    plain sums: torch.float32 multiplies in fp32 (JAX's CPU interpret
    run), torch.bfloat16 rounds w and the operands as the tensor cores
    do."""
    passes = _pass_coeffs(steps, y4, y4_phase, ends)
    for y in range(pos.shape[0]):
        m = None if mass is None else mass[y]
        for coeffs in passes:
            acc = _force_plain(pos[y], m, slots, tile, n_real, softening,
                               mxu, mask_offdiag, mma_dtype)
            _integrate_plain(pos[y], vel[y], acc, mxu, dt, coeffs)


# ----------------------------------------------------------- kernel ---

#: Floats each scratch array of a launch is aligned to (256 bytes).
_ALIGN = 64


@functools.lru_cache(maxsize=64)
def _coef(y4, ends):
    """The kernel's 11 coefficients as a host array: the cycle's (kick_a,
    kick_b, drift) triples, then the end passes' half-kick and opening
    drift; None for Euler steps."""
    if y4 is None:
        return None
    half, h1 = (0.0, 0.0) if ends is None else ends
    return (ctypes.c_float * 11)(*(c for triple in y4 for c in triple),
                                 half, h1)


@functools.lru_cache(maxsize=256)
def _layout(b, n, tile, mxu, kp, multi, largest):
    """The scratch of a launch over b systems of n bodies, as one
    allocation: (floats, the float offset of each array or None, np).
    The arrays: pos (kp floats a row), vel, the bf16 operands, the
    accumulator of a run of several pieces, the partials, the grid
    barrier's count (8 bytes)."""
    np_ = round_up(n, tile)
    rows = b * np_
    width = 8 if mxu else 3
    sizes = (rows * kp, rows * 3, rows * 8 if mxu else 0,
             rows * width if multi else 0, b * largest * 2 * tile * width, 2)
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total if size else None)
        total += round_up(size, _ALIGN)
    return total, tuple(offsets), np_


def _float(x):
    """x as a contiguous fp32 tensor, itself when it is one."""
    if x is None or (x.dtype == torch.float32 and x.is_contiguous()):
        return x
    return x.float().contiguous()


def _launch(pos, vel, mass, slots, tile, steps, dt, softening, mxu,
            mask_offdiag, y4, y4_phase, ends):
    """B15 on the card: the bodies pos, vel (N, 3) or (B, N, 3) and mass
    (N,), (B, N) or None through the passes of resident_plain; returns
    the new (pos, vel) in pos's shape. The kernel pads and packs the bodies
    itself, into one scratch allocation, and writes its outputs once.
    Counted as launch.B15, one a call (a whole trajectory)."""
    if tile not in RESIDENT_TILES:
        raise ValueError(f"the CUDA resident kernel takes tile in "
                         f"{RESIDENT_TILES}, got {tile}")
    _build.refuse_grad("simulate_resident_sym", pos, vel, mass)
    b = 1 if pos.ndim == 2 else pos.shape[0]
    n = pos.shape[-2]
    kp = 4 if mass is not None and not mxu else 3
    pieces, targets, entries, last_target, largest = resident_plan(slots)
    total, offsets, np_ = _layout(b, n, tile, mxu, kp, pieces.shape[0] > 1,
                                  largest)
    device = pos.device
    scratch = torch.empty(total, dtype=torch.float32, device=device)
    ptr = [None if o is None else scratch.data_ptr() + 4 * o
           for o in offsets]
    p_out, v_out = torch.empty((2, *pos.shape), dtype=torch.float32,
                               device=device).unbind(0)
    p_in, v_in, m_in = _float(pos), _float(vel), _float(mass)
    coef = _coef(None if y4 is None else tuple(map(tuple, y4)), ends)
    lib = _build.load_library()
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    with torch.cuda.device(index):
        code = lib.resident_sym_launch(
            slots.data_ptr(), pieces.data_ptr(), pieces.shape[0],
            targets.data_ptr(), entries.data_ptr(), last_target.data_ptr(),
            largest, p_in.data_ptr(), v_in.data_ptr(),
            None if m_in is None else m_in.data_ptr(), p_out.data_ptr(),
            v_out.data_ptr(), *ptr, b, np_, n, steps,
            int(ends is not None), float(dt), float(softening), FAR,
            int(fast_rsqrt_cube(softening)), int(mask_offdiag),
            None if coef is None else ctypes.addressof(coef), y4_phase, tile,
            int(mxu), kp, _build.stream_ptr(device))
    _build.check(lib, code, "resident_sym_launch")
    count("launch.B15")
    return p_out, v_out


# ---------------------------------------------------------- drivers ---

def _run(pos, vel, mass, steps, dt, softening, mxu, tile, coincident, y4,
         y4_phase, fold, ends=None):
    """One system pos, vel (N, 3), mass (N,) or None, or B systems (B, N,
    3), (B, N), through the passes of resident_plain at `tile`: on the card
    the kernel, which pads each system to round_up(N, tile) itself (each
    pad at its own far point, zero velocity and mass); on the CPU its
    plain version on copies padded with FAR positions; either way new
    (pos, vel) in pos's shape."""
    n = pos.shape[-2]
    np_ = round_up(n, tile)
    nb = np_ // tile
    fold = (FOLD_DEFAULT if fold is None else bool(fold)) and nb >= 2
    slots = slot_pipe.slot_table(nb, fold, False, pos.device)
    mask_offdiag = coincident != "fast"
    if _build.on_card(pos.device):
        return _launch(pos, vel, mass, slots, tile, steps, dt, softening,
                       mxu, mask_offdiag, y4, y4_phase, ends)
    shape = pos.shape
    b, pad = (1 if pos.ndim == 2 else shape[0]), np_ - n
    pos, vel = pos.reshape(b, n, 3), vel.reshape(b, n, 3)
    # New tensors even without pads: the run updates them in place.
    p = torch.cat([pos.float(), pos.new_full((b, pad, 3), FAR,
                                             dtype=torch.float32)], dim=1)
    v = torch.cat([vel.float(), vel.new_zeros((b, pad, 3),
                                              dtype=torch.float32)], dim=1)
    m = None
    if mass is not None:
        m = torch.cat([mass.reshape(b, n).float(),
                       mass.new_zeros((b, pad), dtype=torch.float32)], dim=1)
    with torch.no_grad():
        resident_plain(p, v, m, slots, tile, n, steps, dt, softening, mxu,
                       mask_offdiag, y4, y4_phase, ends=ends)
    return (p[:, :n].reshape(shape).contiguous(),
            v[:, :n].reshape(shape).contiguous())


#: ensemble_tiling, once per (N, tile, card or CPU).
_tiling = functools.lru_cache(maxsize=256)(ensemble_tiling)


def _check_steps(steps, what):
    if steps < 1:
        raise ValueError(f"{what} needs steps >= 1")


def _single_tile(pos, tile):
    """The tile of a resident run of one system pos (N, 3), within the
    cap."""
    n = pos.shape[0]
    if n > RESIDENT_SYM_MAX_N:
        raise ValueError(
            f"simulate_resident_sym holds one trajectory in one launch: "
            f"N={n} > RESIDENT_SYM_MAX_N={RESIDENT_SYM_MAX_N}; use "
            "sim.simulate (the streamed kernels)")
    return _tiling(n, tile, _build.on_card(pos.device))[0]


def _ensemble_tile(pos, mass, tile):
    """The tile of a resident run of B systems pos (B, N, 3), whose
    stacked B Np must be within the cap."""
    check_ensemble(pos, mass)
    b, n = pos.shape[0], pos.shape[1]
    kernel = _build.on_card(pos.device)
    if tile is None:
        tile = auto_tile_ensemble(b, n, kernel)
    t, np_ = _tiling(n, tile, kernel)
    if b * np_ > RESIDENT_SYM_MAX_N:
        raise ValueError(
            f"the resident ensemble holds all B systems in one launch: "
            f"B*Np = {b * np_} > {RESIDENT_SYM_MAX_N}; use "
            "sim.simulate_ensemble's streamed path")
    return t


def simulate_resident_sym(pos, vel, mass=None, *, steps: int, dt: float,
                          softening: float = SOFTENING, mxu: bool = False,
                          tile: int | None = None, coincident: str = "auto",
                          y4=None, y4_phase: int = 0, fold=None):
    """`steps` Euler steps of one system pos, vel (N, 3) [, mass (N,)] in
    one launch: returns (pos, vel) after the last step. mxu=False is the
    fp32 class (K3's slot body, backend 'sym'), mxu=True the bf16 class
    (K2's, 'sym_mxu'). y4 (internal: y4_cycle's, or the leapfrog's of
    simulate_resident_sym_kdk) makes each step one (kick_a, kick_b, drift)
    substep, the cycle offset by y4_phase. fold: whether the tri
    slot list folds diagonal block pairs (FOLD_DEFAULT when None).
    coincident: 'auto' is 'masked'; 'fast' drops the off-diagonal d2 == 0
    mask of real bodies (self and pad pairs stay masked). CUDA tensors
    launch B15 (tile 64 or 128), CPU tensors its plain version."""
    check_coincident(coincident)
    t = _single_tile(pos, tile)
    _check_steps(steps, "simulate_resident_sym")
    return _run(pos, vel, mass, steps, dt, softening, mxu, t, coincident,
                y4, y4_phase, fold)


def simulate_resident_sym_ensemble(pos, vel, mass=None, *, steps: int,
                                   dt: float, softening: float = SOFTENING,
                                   mxu: bool = False, tile: int | None = None,
                                   coincident: str = "auto", y4=None,
                                   y4_phase: int = 0, fold=None):
    """B independent systems pos, vel (B, N, 3) [, mass (B, N)] through
    `steps` Euler steps in one launch: the kernel of simulate_resident_sym
    with every system on its own rows and the same slot list, so system i
    is bitwise its standalone run at the same tile. B Np must be at most
    RESIDENT_SYM_MAX_N."""
    check_coincident(coincident)
    check_ensemble(pos, mass)
    _check_steps(steps, "simulate_resident_sym_ensemble")
    t = _ensemble_tile(pos, mass, tile)
    return _run(pos, vel, mass, steps, dt, softening, mxu, t, coincident,
                y4, y4_phase, fold)


def simulate_resident_sym_kdk(pos, vel, mass=None, *, steps: int,
                              dt: float, softening: float = SOFTENING,
                              mxu: bool = False, tile: int | None = None,
                              coincident: str = "auto", fold=None,
                              y4: bool = False):
    """`steps` KDK leapfrog steps (y4 False) or Yoshida-4 steps (y4 True)
    of one system pos, vel (N, 3) [, mass (N,)] or of B systems (B, N, 3)
    [, (B, N)] in one launch: an opening pass (half-kick, drift), the
    steps - 1 leapfrog or 3 steps - 1 Yoshida-4 interior substeps (none for
    one leapfrog step) and a closing pass (half-kick): the streamed loop's
    force passes, and its bits."""
    check_coincident(coincident)
    _check_steps(steps, "simulate_resident_sym_kdk")
    t = (_ensemble_tile(pos, mass, tile) if pos.ndim == 3
         else _single_tile(pos, tile))
    dt = float(dt)
    if y4:
        cycle, h1 = y4_cycle(dt)
    else:  # every substep closes one leapfrog step and opens the next
        cycle, h1 = ((0.5 * dt, 0.5 * dt, dt),) * 3, dt
    half = 0.5 * h1
    k = 3 * steps - 1 if y4 else steps - 1
    return _run(pos, vel, mass, k, dt, softening, mxu, t, coincident, cycle,
                0, fold, ends=(half, h1))


#: JAX's driver names (resident_sym.py:809, :868, :930, :965): the shape of
#: pos picks one system or an ensemble.
simulate_resident_sym_leapfrog = simulate_resident_sym_ensemble_leapfrog = (
    functools.partial(simulate_resident_sym_kdk, y4=False))
simulate_resident_sym_yoshida4 = simulate_resident_sym_ensemble_yoshida4 = (
    functools.partial(simulate_resident_sym_kdk, y4=True))
