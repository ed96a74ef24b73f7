"""Slot-list pair-once traversal: slot lists, fold geometry, and the K2
wrappers.

Counterpart of ``mini_nbody_tpu/ops/slot_pipe.py:81-302``. A self chunk of nb
blocks is covered by an exact slot list of (kind, bi, bj) rows, each block
pair once; with fold, two diagonal blocks (2k, 2k+1) share one full tile
(entry (r, c) is pair (a_r, a_c) for c < r and (b_r, b_c) for c > r; c == r
is always masked). A chunk pair a != b is covered by every (i, j); two
disjoint sets of different lengths by every (i, j) of the na x nb block
rectangle.

``tri_slot_sums_``, ``cross_slot_sums_`` and ``pair_slot_sums_`` ADD the raw
(c, 8) sums of one chunk, one chunk pair or one pair of disjoint sets into
accumulator views: CUDA tensors launch the hand-written kernel
``csrc/slot_pipe.cu`` (K2, which serves the Pallas kernels
``_tri_slot_kernel`` and ``_cross_pair_kernel``, and in its cross mode over a
rectangle B4, sym_mxu_force.py's ``_cross_kernel`` behind
``body_force_pair_mxu``), CPU tensors take
the plain version ``_slot_sums_plain``, which walks the same slot list with
the same masks. ``tri_slot_sums_ensemble_`` (B9a, the counterpart of
``build_tri_slot_ensemble``, ``:355-398``) runs K2's tri mode over B systems
stacked in one (B c, 8) accumulator, each system the same slot list over its
own blocks. ``build_tri_slot_call`` / ``build_cross_slot_call`` return
the raw sums in the JAX (8, c) layout; the positions go in as (c, 3) only
(no (3, c) transpose: the kernel reads both orientations from one copy).

The slot kernels K2, K3 (ops/symmetric_force.py), B11 and B12
(ops/vjp_kernel.py) and B13 (ops/vjp_mxu.py) sum deterministically:
``run_slot_pieces`` cuts the slot list into pieces of PIECE_SLOTS
system-local slots, launches a kernel that stores two partial tiles per
slot, and then ``csrc/slot_reduce.cu``, which adds each block's partials in
slot order. The plan of that reduction is built once per slot table
(``reduce_plan``).
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.ops.sym_mxu_force import _w_block, _w_from_d, _w_parts
from mini_nbody_tpu_torch.utils.config import (fast_rsqrt_cube,
                                               plain_block_elems)
from mini_nbody_tpu_torch.utils.tracing import count

SLOT_DIAG = 0
SLOT_CROSS = 1
SLOT_FOLD = 2

#: The tiles the CUDA kernel is compiled for.
KERNEL_TILES = (64, 128)

#: The registry's counter of each kind of K2 call (utils/tracing.count),
#: counted at each launch on CUDA tensors: a call makes one launch of its
#: kernel per piece of its slot list and group of systems, and one
#: slot_reduce launch after each (launch.slot_reduce, behind K2, K3, B11,
#: B12 and B13; run_slot_pieces). "pair" is body_force_pair_mxu's cross
#: mode (B4), "ensemble" tri_slot_sums_ensemble_ (B9a).
COUNTERS = {"tri": "launch.K2.tri", "cross": "launch.K2.cross",
            "pair": "launch.B4", "ensemble": "launch.B9a"}

#: System-local slots per piece. A slot list is cut at multiples of this, so
#: the grouping of every add depends on the slot list alone, never on the
#: number of systems in a launch; an ensemble launch takes as many systems
#: as keep it at or under PIECE_SLOTS slots (at most MAX_SYSTEMS, the
#: kernels' gridDim.y). Each slot stores two
#: (tile, width) fp32 partials: at tile 128 a piece's scratch holds 201 MB
#: for K3 and 537 MB for K2.
PIECE_SLOTS = 1 << 16
MAX_SYSTEMS = 65535


def tri_slot_list(nb: int, fold: bool = True):
    """Self-chunk slot list: (kind, bi, bj) rows, each block pair once.
    With fold, diagonal pairs (2k, 2k+1) fold into one slot (odd nb leaves
    the last diagonal unfolded). Cross slots run i-major."""
    rows = []
    for i in range(nb):
        if fold and i % 2 == 0 and i + 1 < nb:
            rows.append((SLOT_FOLD, i, i + 1))
        elif not fold or i % 2 == 0:
            rows.append((SLOT_DIAG, i, i))
        rows.extend((SLOT_CROSS, i, j) for j in range(i + 1, nb))
    return rows


def cross_slot_list(nb: int):
    """Chunk-pair slot list: every (i, j), i-major."""
    return [(SLOT_CROSS, i, j) for i in range(nb) for j in range(nb)]


def n_slots_tri(nb: int, fold: bool = True) -> int:
    return len(tri_slot_list(nb, fold))


@functools.lru_cache(maxsize=32)
def _slot_table(nb: int, fold: bool, cross: bool, device: str, nb_b: int):
    if cross:  # cross_slot_list, built without a Python list of nb^2 rows
        i, j = np.meshgrid(np.arange(nb), np.arange(nb_b), indexing="ij")
        rows = np.stack([np.full(i.size, SLOT_CROSS), i.ravel(), j.ravel()],
                        axis=1)
    else:
        rows = np.asarray(tri_slot_list(nb, fold)).reshape(-1, 3)
    return torch.from_numpy(rows.astype(np.int32)).to(device)


def slot_table(nb: int, fold: bool, cross: bool, device,
               nb_b: int | None = None) -> torch.Tensor:
    """The (S, 3) int32 slot list (tri_slot_list, or cross_slot_list when
    cross; nb_b makes the cross list an nb x nb_b rectangle) on device,
    built once per (nb, fold, cross, device, nb_b)."""
    return _slot_table(nb, bool(fold) and not cross, bool(cross),
                       str(torch.device(device)), nb if nb_b is None else nb_b)


def plan_pieces(rows: np.ndarray, tri: bool):
    """The reduction plan of an (S, 3) slot list, per piece of PIECE_SLOTS
    slots: (first slot, slots, targets, offsets, entries). Slot s of a
    piece stores tile 2 s (side 0: block bi) and, unless it is DIAG, tile
    2 s + 1 (side 1: block bj). A target is block * 2 + accumulator (1 for
    side b of a cross launch, else 0); entries[offsets[t]:offsets[t + 1]]
    are its tiles in slot order."""
    pieces = []
    for s0 in range(0, rows.shape[0], PIECE_SLOTS):
        part = rows[s0:s0 + PIECE_SLOTS]
        local = np.arange(part.shape[0])
        two = part[:, 0] != SLOT_DIAG
        target = np.concatenate([part[:, 1] * 2,
                                 part[two, 2] * 2 + (0 if tri else 1)])
        entry = np.concatenate([local * 2, local[two] * 2 + 1])
        order = np.lexsort((entry, target))
        target, entry = target[order], entry[order]
        targets, starts = np.unique(target, return_index=True)
        pieces.append((s0, part.shape[0], targets,
                       np.append(starts, target.shape[0]), entry))
    return pieces


def launch_order(offsets: np.ndarray) -> np.ndarray:
    """The targets of a piece (CSR ``offsets``) longest list first, ties in
    target order: the order csrc/slot_reduce.cu starts their CTAs in, so
    the longest chains of adds are not left to the last wave."""
    return np.argsort(-np.diff(offsets), kind="stable")


#: The reduction plans of the live slot tables: id(table) -> {(tri,
#: PIECE_SLOTS): plan}, each entry dropped with its table.
_PLANS: dict[int, dict] = {}


def reduce_plan(slots: torch.Tensor, tri: bool):
    """plan_pieces of a slot table, each piece with its launch_order as a
    6th field ((first slot, slots, targets, offsets, entries, order)), the
    index arrays on the table's device, built from one host copy of the
    table once per table, mode and PIECE_SLOTS."""
    key = id(slots)
    if key not in _PLANS:
        _PLANS[key] = {}
        weakref.finalize(slots, _PLANS.pop, key, None)
    plans = _PLANS[key]
    if (tri, PIECE_SLOTS) not in plans:
        plans[tri, PIECE_SLOTS] = [
            (s0, n, *(torch.from_numpy(a.astype(np.int32)).to(slots.device)
                      for a in (*arrays, launch_order(arrays[1]))))
            for s0, n, *arrays in plan_pieces(slots.cpu().numpy(), tri)]
    return plans[tri, PIECE_SLOTS]


def system_groups(n_sys: int, longest: int):
    """(first system, systems) of each launch over n_sys systems whose
    longest piece has ``longest`` slots: as many systems as keep a launch at
    or under PIECE_SLOTS slots, at least one and at most MAX_SYSTEMS."""
    group = min(n_sys, max(1, PIECE_SLOTS // longest), MAX_SYSTEMS)
    return [(g0, min(group, n_sys - g0)) for g0 in range(0, n_sys, group)]


def slot_reduce_(part, piece_plan, acc_a, acc_b, tile, width, n_sys=1,
                 sys_rows=0):
    """Add the partials ``part`` of one piece (n_sys systems of
    2 n_slots (tile, width) fp32 tiles each) into acc_a / acc_b ((rows,
    width), system s at row s * sys_rows) in slot order, as the piece's
    plan (from reduce_plan) says: csrc/slot_reduce.cu on CUDA tensors
    (which refuses a tile of tile * width not a multiple of 4, or part or
    an accumulator not 16-byte aligned), slot_reduce_plain on CPU
    tensors."""
    _, n, targets, offsets, entries, order = piece_plan
    if not _build.on_card(part.device):
        slot_reduce_plain(part, piece_plan, acc_a, acc_b, tile, width, n_sys,
                          sys_rows)
        return
    lib = _build.load_library()
    code = lib.slot_reduce_launch(
        part.data_ptr(), tile * width, targets.shape[0], targets.data_ptr(),
        offsets.data_ptr(), entries.data_ptr(), order.data_ptr(),
        acc_a.data_ptr(), acc_b.data_ptr(), n_sys, sys_rows * width, n * 2,
        _build.stream_ptr(part.device))
    _build.check(lib, code, "slot_reduce_launch")
    count("launch.slot_reduce")


def slot_reduce_plain(part, piece_plan, acc_a, acc_b, tile, width, n_sys=1,
                      sys_rows=0):
    """Plain version of slot_reduce_: each target's tiles summed in slot
    order, one target at a time."""
    _, n, targets, offsets, entries = piece_plan[:5]
    tiles = part[:n_sys * n * 2 * tile * width].view(n_sys, n * 2, tile,
                                                     width)
    offsets, entries = offsets.tolist(), entries.tolist()
    for s in range(n_sys):
        for t, target in enumerate(targets.tolist()):
            acc = acc_b if target & 1 else acc_a
            r0 = s * sys_rows + (target >> 1) * tile
            total = torch.zeros((tile, width), dtype=part.dtype,
                                device=part.device)
            for e in entries[offsets[t]:offsets[t + 1]]:
                total = total + tiles[s, e]
            acc[r0:r0 + tile] += total


def run_slot_pieces(what, slots, tri, tile, width, acc_a, acc_b, launch,
                    counter, n_sys=1, sys_rows=0):
    """Drive one slot kernel deterministically: for each piece of the slot
    list and each group of systems, ``launch(piece, n_slots, n_sys_group,
    first_system, part)`` stores the per-slot partials ((tile, width) fp32
    tiles, two per slot) in ``part`` and returns the CUDA status, and the
    registry counter ``counter`` counts that launch; then slot_reduce_ adds
    them into acc_a / acc_b ((rows, width), system s at row s * sys_rows)
    in slot order."""
    plan = reduce_plan(slots, tri)
    if not plan or n_sys == 0:
        return
    lib = _build.load_library()
    groups = system_groups(n_sys, max(n for _, n, *_ in plan))
    part = torch.empty(groups[0][1] * min(slots.shape[0], PIECE_SLOTS) * 2
                       * tile * width, dtype=torch.float32,
                       device=acc_a.device)
    for piece_plan in plan:
        s0, n = piece_plan[:2]
        for g0, g in groups:
            _build.check(lib, launch(slots[s0:s0 + n], n, g, g0, part), what)
            count(counter)
            slot_reduce_(part, piece_plan, acc_a[g0 * sys_rows:],
                         acc_b[g0 * sys_rows:], tile, width, g, sys_rows)


def _w_fold_block(pa, pb, softening, fast, mask_offdiag):
    """Folded two-diagonal w for batched blocks a (B,T,3) and b (B,T,3):
    (w_lo, w_hi), the lower triangle from a and the upper from b, self
    diagonal always masked, d2 == 0 masked iff mask_offdiag."""
    t = pa.shape[1]
    idx = torch.arange(t, device=pa.device)
    lower = idx[None, :] < idx[:, None]  # [r, c]: c < r
    d = [torch.where(lower, pa[:, None, :, k] - pa[:, :, None, k],
                     pb[:, None, :, k] - pb[:, :, None, k]) for k in range(3)]
    w = _w_from_d(*d, softening, fast, mask_offdiag)
    w = torch.where(idx[None, :] == idx[:, None], torch.zeros_like(w), w)
    w_lo = torch.where(lower, w, torch.zeros_like(w))
    return w_lo, w - w_lo


def _mm(w_parts, v, transpose, mma_dtype):
    """sum over parts of W @ v (or W^T @ v); bf16 mode rounds both
    operands to bf16 as the tensor cores do (products are exact in fp32)."""
    if mma_dtype == torch.bfloat16:
        v = v.to(torch.bfloat16).float()
    out = 0
    for wp in w_parts:
        if mma_dtype == torch.bfloat16:
            wp = wp.to(torch.bfloat16).float()
        out = out + torch.bmm(wp.transpose(1, 2) if transpose else wp, v)
    return out


def _slot_sums_plain(acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
                     softening, split_w, mask_offdiag,
                     mma_dtype=torch.float32):
    """Plain version of K2: add the raw sums of every slot into acc_a
    (rows, block bi) and acc_b (reactions, block bj), in batches of slots."""
    fast = fast_rsqrt_cube(softening)
    pa, pb = pos_a.view(-1, tile, 3), pos_b.view(-1, tile, 3)
    va, vb = v_a.view(-1, tile, 8), v_b.view(-1, tile, 8)
    aa, ab = acc_a.view(-1, tile, 8), acc_b.view(-1, tile, 8)
    slots = slots.to(device=pos_a.device, dtype=torch.long)
    batch = max(1, plain_block_elems(pos_a.device) // (tile * tile))
    for kind in (SLOT_DIAG, SLOT_CROSS, SLOT_FOLD):
        sel = slots[slots[:, 0] == kind]
        for s in range(0, sel.shape[0], batch):
            bi, bj = sel[s:s + batch, 1], sel[s:s + batch, 2]
            if kind == SLOT_FOLD:
                w_lo, w_hi = _w_fold_block(pa[bi], pb[bj], softening, fast,
                                           mask_offdiag)
                lo = _w_parts(w_lo, split_w)
                hi = _w_parts(w_hi, split_w)
                aa.index_add_(0, bi, _mm(lo, va[bi], False, mma_dtype)
                              + _mm(lo, va[bi], True, mma_dtype))
                ab.index_add_(0, bj, _mm(hi, vb[bj], False, mma_dtype)
                              + _mm(hi, vb[bj], True, mma_dtype))
                continue
            w = _w_parts(_w_block(pa[bi], pb[bj], softening, fast,
                                  mask=kind == SLOT_DIAG or mask_offdiag),
                         split_w)
            aa.index_add_(0, bi, _mm(w, vb[bj], False, mma_dtype))
            if kind == SLOT_CROSS:
                ab.index_add_(0, bj, _mm(w, va[bi], True, mma_dtype))


def _check_sides(acc_a, acc_b, pos_a, pos_b, v_a, v_b, tile):
    device = pos_a.device
    for side, c, tensors in (("a", pos_a.shape[0], (pos_a, v_a, acc_a)),
                             ("b", pos_b.shape[0], (pos_b, v_b, acc_b))):
        if c % tile != 0:
            raise ValueError(f"side {side} has {c} rows, not a multiple of "
                             f"tile {tile}")
        for name, t, width in zip(("pos_", "v_", "acc_"), tensors, (3, 8, 8)):
            _build.check_tensor(name + side, t, (c, width), torch.float32,
                                device)


def _run_kernel(kind, acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
                softening, split_w, mask_offdiag, n_sys=1, sys_rows=0):
    """K2 on the card over n_sys systems of sys_rows rows (tri mode), a
    call of a ``kind`` of COUNTERS."""
    _build.refuse_grad("slot_pipe", pos_a, pos_b, v_a, v_b)
    if tile not in KERNEL_TILES:
        raise ValueError(f"the CUDA slot kernel takes tile in {KERNEL_TILES}, "
                         f"got {tile}")
    lib = _build.load_library()
    device = pos_a.device
    fast = int(fast_rsqrt_cube(softening))

    def launch(piece, n, g, g0, part):
        r0 = g0 * sys_rows
        return lib.slot_pipe_launch(
            piece.data_ptr(), n, g, sys_rows, pos_a[r0:].data_ptr(),
            pos_b[r0:].data_ptr(), v_a[r0:].data_ptr(), v_b[r0:].data_ptr(),
            part.data_ptr(), tile, float(softening), fast, int(split_w),
            int(mask_offdiag), _build.stream_ptr(device))

    with torch.cuda.device(device):
        run_slot_pieces("slot_pipe_launch", slots,
                        kind in ("tri", "ensemble"), tile, 8, acc_a, acc_b,
                        launch, COUNTERS[kind], n_sys, sys_rows)


def _launch(cross, acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
            softening, split_w, mask_offdiag, pair=False):
    """Side a has pos_a's rows and side b pos_b's (the same in tri mode and
    for a chunk pair, any multiple of tile for a pair of sets)."""
    device = pos_a.device
    _check_sides(acc_a, acc_b, pos_a, pos_b, v_a, v_b, tile)
    if not cross and pos_a.shape[0] != pos_b.shape[0]:
        raise ValueError("tri mode takes one chunk: pos_a and pos_b rows "
                         "must agree")
    _build.check_tensor("slots", slots, (slots.shape[0], 3), torch.int32,
                        device)
    if not _build.on_card(device):
        _slot_sums_plain(acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
                         softening, split_w, mask_offdiag)
        return
    kind = "pair" if pair else "cross" if cross else "tri"
    _run_kernel(kind, acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
                softening, split_w, mask_offdiag)


def tri_slot_sums_(acc, pos, v, slots, tile, softening, split_w=False,
                   mask_offdiag=True):
    """Self chunk: add the raw sums of pos (c,3), v (c,8) over ``slots``
    (a tri slot_table) into acc (c, 8)."""
    _launch(False, acc, acc, pos, pos, v, v, slots, tile, softening,
            split_w, mask_offdiag)


def tri_slot_sums_ensemble_(acc, pos, v, slots, tile, softening, n_sys,
                            split_w=False, mask_offdiag=True):
    """B independent self chunks (B9a): systems of c = rows / n_sys rows
    stacked in pos (B c, 3), v (B c, 8) and acc (B c, 8), each summed over
    the same tri ``slots`` into its own rows. System i's sums are bitwise
    those of tri_slot_sums_ on its rows alone, on the card (one kernel,
    the same pieces; a launch takes as many systems as system_groups
    allows) and on the CPU (the same plain walk, system by system)."""
    rows = pos.shape[0]
    if n_sys < 1 or rows % n_sys != 0:
        raise ValueError(f"{rows} rows do not split into {n_sys} systems")
    c = rows // n_sys
    device = pos.device
    _check_sides(acc, acc, pos, pos, v, v, tile)
    if c % tile != 0:
        raise ValueError(f"a system has {c} rows, not a multiple of tile "
                         f"{tile}")
    _build.check_tensor("slots", slots, (slots.shape[0], 3), torch.int32,
                        device)
    if not _build.on_card(device):
        for i in range(n_sys):
            sl = slice(i * c, (i + 1) * c)
            _slot_sums_plain(acc[sl], acc[sl], pos[sl], pos[sl], v[sl],
                             v[sl], slots, tile, softening, split_w,
                             mask_offdiag)
        return
    _run_kernel("ensemble", acc, acc, pos, pos, v, v, slots, tile,
                softening, split_w, mask_offdiag, n_sys, c)


def cross_slot_sums_(acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
                     softening, split_w=False, mask=True):
    """Chunk pair a != b: rows into acc_a, reactions into acc_b."""
    _launch(True, acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
            softening, split_w, mask)


def pair_slot_sums_(acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
                    softening, split_w=False, mask=True):
    """Two disjoint sets (body_force_pair_mxu): cross mode over the
    (na / tile) x (nb / tile) rectangle ``slots``, rows into acc_a (na, 8),
    reactions into acc_b (nb, 8)."""
    _launch(True, acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
            softening, split_w, mask, pair=True)


def tri_slot_sums_plain(pos, v, softening, tile, fold=True,
                        mask_offdiag=True, split_w=False,
                        mma_dtype=torch.float32):
    """Plain raw sums of one self chunk in the JAX (8, c) layout.
    mma_dtype=torch.float32 multiplies in fp32 (JAX's CPU interpret run);
    torch.bfloat16 rounds w and v as the tensor cores do."""
    nb = pos.shape[0] // tile
    acc = torch.zeros((pos.shape[0], 8), dtype=torch.float32,
                      device=pos.device)
    slots = slot_table(nb, fold and nb > 1, False, pos.device)
    _slot_sums_plain(acc, acc, pos, pos, v, v, slots, tile, softening,
                     split_w, mask_offdiag, mma_dtype)
    return acc.T


def cross_slot_sums_plain(pa, pb, va, vb, softening, tile, mask=True,
                          split_w=False, mma_dtype=torch.float32):
    """Plain raw sums of one chunk pair, or of two disjoint sets of any
    lengths that are multiples of tile: (acc_a (8, na), acc_b (8, nb))."""
    acc_a = torch.zeros((pa.shape[0], 8), dtype=torch.float32,
                        device=pa.device)
    acc_b = torch.zeros((pb.shape[0], 8), dtype=torch.float32,
                        device=pb.device)
    slots = slot_table(pa.shape[0] // tile, False, True, pa.device,
                       nb_b=pb.shape[0] // tile)
    _slot_sums_plain(acc_a, acc_b, pa, pb, va, vb, slots, tile, softening,
                     split_w, mask, mma_dtype)
    return acc_a.T, acc_b.T


def build_tri_slot_call(softening, tile, c, split_w=False, mask_offdiag=True,
                        fold=True):
    """Self-chunk call: (pos (c,3), v (c,8)) -> raw sums (8, c)."""
    nb = c // tile
    fold = fold and nb > 1

    def call(pos, v):
        acc = torch.zeros((c, 8), dtype=torch.float32, device=pos.device)
        tri_slot_sums_(acc, pos, v, slot_table(nb, fold, False, pos.device),
                       tile, softening, split_w, mask_offdiag)
        return acc.T

    return call


def build_cross_slot_call(softening, tile, c, split_w=False, mask=True):
    """Chunk-pair call: (pos_a, pos_b, v_a, v_b) -> (acc_a (8, c),
    acc_b (8, c)) raw sums."""
    nb = c // tile

    def run(pa, pb, va, vb):
        acc_a = torch.zeros((c, 8), dtype=torch.float32, device=pa.device)
        acc_b = torch.zeros_like(acc_a)
        cross_slot_sums_(acc_a, acc_b, pa, pb, va, vb,
                         slot_table(nb, False, True, pa.device), tile,
                         softening, split_w, mask)
        return acc_a.T, acc_b.T

    return run
