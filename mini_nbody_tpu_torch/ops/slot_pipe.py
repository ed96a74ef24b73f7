"""Slot-list pair-once traversal: slot lists, fold geometry, and the K2
wrappers.

Counterpart of ``mini_nbody_tpu/ops/slot_pipe.py:81-302``. A self chunk of nb
blocks is covered by an exact slot list of (kind, bi, bj) rows, each block
pair once; with fold, two diagonal blocks (2k, 2k+1) share one full tile
(entry (r, c) is pair (a_r, a_c) for c < r and (b_r, b_c) for c > r; c == r
is always masked). A chunk pair a != b is covered by every (i, j).

``tri_slot_sums_`` and ``cross_slot_sums_`` ADD the raw (c, 8) sums of one
chunk or chunk pair into accumulator views: CUDA tensors launch the
hand-written kernel ``csrc/slot_pipe.cu`` (K2, which serves both Pallas
kernels ``_tri_slot_kernel`` and ``_cross_pair_kernel``), CPU tensors take
the plain version ``_slot_sums_plain``, which walks the same slot list with
the same masks. ``build_tri_slot_call`` / ``build_cross_slot_call`` return
the raw sums in the JAX (8, c) layout; the positions go in as (c, 3) only
(no (3, c) transpose: the kernel reads both orientations from one copy).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.ops.sym_mxu_force import _w_block, _w_from_d, _w_parts
from mini_nbody_tpu_torch.utils.config import (fast_rsqrt_cube,
                                               plain_block_elems)

SLOT_DIAG = 0
SLOT_CROSS = 1
SLOT_FOLD = 2

#: The tiles the CUDA kernel is compiled for.
KERNEL_TILES = (64, 128)

#: Kernel launches made by tri_slot_sums_ and cross_slot_sums_ (CUDA
#: tensors only); CROSS_LAUNCHES counts the cross-mode share of them.
LAUNCHES = 0
CROSS_LAUNCHES = 0


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


def _launch(cross, acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
            softening, split_w, mask_offdiag):
    c = pos_a.shape[0]
    device = pos_a.device
    if c % tile != 0:
        raise ValueError(f"chunk {c} is not a multiple of tile {tile}")
    for name, t, width in (("pos_a", pos_a, 3), ("pos_b", pos_b, 3),
                           ("v_a", v_a, 8), ("v_b", v_b, 8),
                           ("acc_a", acc_a, 8), ("acc_b", acc_b, 8)):
        _build.check_tensor(name, t, (c, width), torch.float32, device)
    _build.check_tensor("slots", slots, (slots.shape[0], 3), torch.int32,
                        device)
    if device.type == "cpu":
        _slot_sums_plain(acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
                         softening, split_w, mask_offdiag)
        return
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if tile not in KERNEL_TILES:
        raise ValueError(f"the CUDA slot kernel takes tile in {KERNEL_TILES}, "
                         f"got {tile}")
    global LAUNCHES, CROSS_LAUNCHES
    lib = _build.load_library()
    with torch.cuda.device(device):
        code = lib.slot_pipe_launch(
            slots.data_ptr(), slots.shape[0], pos_a.data_ptr(),
            pos_b.data_ptr(), v_a.data_ptr(), v_b.data_ptr(),
            acc_a.data_ptr(), acc_b.data_ptr(), tile, float(softening),
            int(fast_rsqrt_cube(softening)), int(split_w), int(mask_offdiag),
            _build.stream_ptr(device))
    _build.check(lib, code, "slot_pipe_launch")
    LAUNCHES += 1
    CROSS_LAUNCHES += int(cross)


def tri_slot_sums_(acc, pos, v, slots, tile, softening, split_w=False,
                   mask_offdiag=True):
    """Self chunk: add the raw sums of pos (c,3), v (c,8) over ``slots``
    (a tri slot_table) into acc (c, 8)."""
    _launch(False, acc, acc, pos, pos, v, v, slots, tile, softening,
            split_w, mask_offdiag)


def cross_slot_sums_(acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
                     softening, split_w=False, mask=True):
    """Chunk pair a != b: rows into acc_a, reactions into acc_b."""
    _launch(True, acc_a, acc_b, pos_a, pos_b, v_a, v_b, slots, tile,
            softening, split_w, mask)


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
    """Plain raw sums of one chunk pair: (acc_a (8, c), acc_b (8, c))."""
    nb = pa.shape[0] // tile
    acc_a = torch.zeros((pa.shape[0], 8), dtype=torch.float32,
                        device=pa.device)
    acc_b = torch.zeros_like(acc_a)
    slots = slot_table(nb, False, True, pa.device)
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
