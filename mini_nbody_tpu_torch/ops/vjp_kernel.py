"""The force VJP in the fp32 class: ordered (B10) and pair-once (B11).

Counterpart of ``mini_nbody_tpu/ops/vjp_kernel.py`` (``:45-103``
_ordered_rows, ``:106-147`` _vjp_kernel, ``:150-216`` _pair_grad_block,
``:219-270`` _ordered_block, ``:273-323`` _sym_vjp_tri_kernel, ``:331-448``
vjp_pos_sym, ``:575-662`` vjp_pos_rect, ``:670-773`` vjp_pos_pallas). With
d = p_j - p_k, s = |d|^2 + eps, inv = rsqrt(s), w = inv^3, u = w inv^2 and
the cotangent g of F:

    pos_bar_k = sum_j m_j [ -w g_k + 3 u (g_k.d) d ]      (receiver)
              + m_k sum_j [  w g_j - 3 u (g_j.d) d ]      (source)

and with unit masses both fold into sum_j [3 u ((g_k - g_j).d) d + w g_j]
- g_k sum_j w. w and u are zeroed where the pre-softening |d|^2 == 0: at
softening 1e-9 the self pair's eps^-1.5 weight would swamp the fp32 sums
(the +-w g_k cancellation is analytic only).

- ``vjp_pos_direct`` (JAX ``vjp_pos_pallas``; the port names that backend
  ``direct``) and ``vjp_pos_rect`` launch B10, the ordered kernel of
  ``csrc/vjp_kernel.cu`` (register micro-tiles of up to 4 receivers a
  thread, the mass terms fused per pair; its bits depend on ``block``
  alone); CPU tensors take ``vjp_ordered_plain``.
- ``vjp_pos_sym`` launches B11 (same source) on K3's slot + fold geometry
  and chunk loop (``ops/symmetric_force.py``): each unordered pair's w and
  u once, and its term t = w (m_a g_b - m_b g_a) + c d, c = 3 u (m_b (g_a.d)
  - m_a (g_b.d)), added to a's row and subtracted from b's reaction (the
  pair's gradient sums to zero). DIAG slots take the ordered formula over
  their block. With mass_grad the mass cotangent rides as a 4th column:
  -w (g_b.d) on the row side and +w (g_a.d) on the reaction side (NOT
  antisymmetric). CPU tensors take ``vjp_sym_sums_plain``, which walks the
  same slot list. The port's B11 has no single-launch bound: it chunks as
  K3 does, so autodiff may send it any N. It sums deterministically
  (``slot_pipe.run_slot_pieces``), as K3 does.

``vjp_pos_sym_ensemble`` (JAX ``:451-572``) launches B9c: B11 with the
system on ``blockIdx.y``, B systems of c = round_up(N, tile) rows stacked,
each its own chunk over the same tri slot list (``vjp_sym_sums_ensemble_``,
as many systems in a launch as ``slot_pipe.system_groups`` allows). System
i is bitwise ``vjp_pos_sym(pos[i], g[i], mass[i], tile=t)`` for N up to
the chunk. Its plain version is ``vjp_sym_sums_plain`` with the system
axis.

Padding: B10 pads nothing (the kernel fills its ragged j tile with FAR,
zero mass and zero cotangent in shared memory); B11 and B9c reuse K3's
packing, FAR tails with zero mass in both mass modes, and zero cotangents
(JAX pads mass mode at the origin instead; both are inert).

``vjp_pos_pair`` (JAX ``:776-949``) launches B12, the 2-D grid's backward
(``parallel/sharded.py``): the VJP of the ordered pairs a <- b with a's
cotangents only, each pair once, on a cross slot table over a's row blocks
and b's column blocks (B11's slot walk on 4 x 16 register micro-tiles,
B11's term with g_b = 0), every pair masked, each slot's a_bar and b_bar
partials added in slot order by ``slot_pipe.run_slot_pieces``. CPU tensors
take ``vjp_pos_pair_plain``, JAX's ``_onesided_grad_block`` in row
blocks.
"""

from __future__ import annotations

import math

import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.ops import slot_pipe
from mini_nbody_tpu_torch.ops.direct_force import _check_block
from mini_nbody_tpu_torch.ops.slot_pipe import SLOT_CROSS, SLOT_DIAG, SLOT_FOLD
from mini_nbody_tpu_torch.ops.sym_mxu_force import (
    _resolve_tiling, any_coincident, any_coincident_ensemble, ensemble_tiling,
    pack_ensemble, resolve_auto)
from mini_nbody_tpu_torch.ops.symmetric_force import _pack
from mini_nbody_tpu_torch.utils.config import (SOFTENING, SYM_BWD_TILES,
                                               check_coincident,
                                               plain_block_elems)
from mini_nbody_tpu_torch.utils.tracing import count

#: Tile of the pair-once backward when the caller names none. On the
#: register micro-tiles one call at N = 65,536 with masses took 4.22-4.28
#: ms at 128 and 4.94-5.06 ms at 64, and the 16 x 65,536 ensemble backward
#: (B9c) 71.4 ms against 84.1-84.2 (ab_slots.py --only pvjp, NVIDIA H100
#: 80GB HBM3 at 700 W); the shared-tile kernel before them took 9.68 ms at
#: 64 and 11.41 at 128.
DEFAULT_TILE = 128

#: The registry's counters (utils/tracing.count), counted at each launch
#: on CUDA tensors: vjp_pos_direct / vjp_pos_rect count launch.B10, one per
#: call; vjp_pos_pair launch.B12, one per piece of its cross slot table
#: (slot_pipe.PIECE_SLOTS slots), each followed by one launch.slot_reduce;
#: vjp_sym_sums_ (B11) and vjp_sym_sums_ensemble_ (B9c) count SYM_COUNTERS
#: by kind, one per piece of the slot list and group of systems
#: (slot_pipe.run_slot_pieces).
SYM_COUNTERS = {"tri": "launch.B11.tri", "cross": "launch.B11.cross",
                "ensemble": "launch.B9c"}

#: The coincident gates: below this many bodies 'auto' is 'masked', without
#: the duplicate scan. chip_smoke.py's coincident_gate phase (4096 ..
#: 262,144, an H100): the scan pays for B10 from 131,072 on
#: (COINCIDENT_AUTO_MIN_N); for B11 at no measured
#: N, its maskless kernel being no faster, so B11's 'auto' is 'masked' at
#: every N (SYM_COINCIDENT_AUTO_MIN_N infinite).
COINCIDENT_AUTO_MIN_N = 131072
SYM_COINCIDENT_AUTO_MIN_N = math.inf


def _w_u(d2, softening, mask):
    """w = s^-3/2 and u = s^-5/2 through rsqrt, zeroed where mask."""
    inv = torch.rsqrt(d2 + softening)
    inv2 = inv * inv
    w = inv2 * inv
    u = w * inv2
    if mask is not None:
        w = torch.where(mask, torch.zeros_like(w), w)
        u = torch.where(mask, torch.zeros_like(u), u)
    return w, u


def _ordered_rows(pk, gk, pj, gj, softening, mass_rows=False):
    """Ordered pos_bar rows (..., R, 3) of receivers pk (..., R, 3|4) over
    sources pj (..., J, 3|4), masses as the 4th column (unit masses
    without), d2 == 0 masked (JAX _ordered_rows / _ordered_block). With
    mass_rows also the mass cotangent of each receiver, -sum_j w (g_j.d)
    (..., R): the sum JAX takes as column sums of the same block."""
    d = [pj[..., None, :, k] - pk[..., :, None, k] for k in range(3)]
    dx, dy, dz = d
    d2 = dx * dx + dy * dy + dz * dz
    w, u = _w_u(d2, softening, d2 == 0.0)
    gkc = [gk[..., :, None, k] for k in range(3)]
    gjc = [gj[..., None, :, k] for k in range(3)]
    dot_k = gkc[0] * dx + gkc[1] * dy + gkc[2] * dz
    dot_j = gjc[0] * dx + gjc[1] * dy + gjc[2] * dz
    if pk.shape[-1] == 3:
        coeff = 3.0 * (u * (dot_k - dot_j))
        sw = w.sum(-1)
        rows = [(coeff * dk + w * gjk).sum(-1) - gk[..., k] * sw
                for k, (dk, gjk) in enumerate(zip(d, gjc))]
    else:
        mj, mk = pj[..., None, :, 3], pk[..., 3]
        a = 3.0 * (u * mj * dot_k)
        smw = (w * mj).sum(-1)
        b = 3.0 * (u * dot_j)
        rows = [((a * dk).sum(-1) - gk[..., k] * smw)
                + mk * (w * gjk - b * dk).sum(-1)
                for k, (dk, gjk) in enumerate(zip(d, gjc))]
    rows = torch.stack(rows, -1)
    if mass_rows:
        return rows, -(w * dot_j).sum(-1)
    return rows


def vjp_ordered_plain(pos_k, g_k, pos_j, g_j, mass_k=None, mass_j=None,
                      softening: float = SOFTENING):
    """B10's arithmetic in PyTorch, in row blocks, every block masked:
    pos_bar rows (Nk, 3) of receivers (pos_k, g_k) over sources (pos_j,
    g_j), masses both or neither."""
    pk, pj = pos_k, pos_j
    if mass_k is not None:
        pk = torch.cat([pos_k, mass_k[:, None]], 1)
        pj = torch.cat([pos_j, mass_j[:, None]], 1)
    rows = max(1, plain_block_elems(pos_k.device) // max(1, pj.shape[0]))
    out = [_ordered_rows(pk[r:r + rows], g_k[r:r + rows], pj, g_j, softening)
           for r in range(0, pk.shape[0], rows)]
    if not out:
        return pos_k.new_zeros((0, 3))
    return torch.cat(out)


def ordered_receivers(block: int) -> int:
    """Receivers per thread of B10 at ``block`` (csrc/vjp_kernel.cu
    ``ordered_r``): 4 where block / 4 threads keep whole warps, else 2, else
    1. Thread i of a CTA owns receivers i + (block / R) r, r < R, so a CTA
    runs block / R threads, the count ``vjp_ordered_info`` reports."""
    return 4 if block % 128 == 0 else 2 if block % 64 == 0 else 1


def _ordered(pos_k, g_k, pos_j, g_j, mass_k, mass_j, softening, block,
             square_coincident=None):
    """Validate, then B10 on CUDA tensors or its plain version on CPU ones.
    square_coincident: the coincident mode of a square call (the kernel
    drops the d2 == 0 select in tiles whose k and j ranges do not
    intersect when no two distinct bodies coincide); None for rectangular
    calls, which mask every tile."""
    device = pos_k.device
    nk, nj = pos_k.shape[0], pos_j.shape[0]
    f32 = torch.float32
    for name, t, shape in (("pos_k", pos_k, (nk, 3)), ("g_k", g_k, (nk, 3)),
                           ("pos_j", pos_j, (nj, 3)), ("g_j", g_j, (nj, 3)),
                           ("mass_k", mass_k, (nk,)),
                           ("mass_j", mass_j, (nj,))):
        if t is not None:
            _build.check_tensor(name, t, shape, f32, device)
    if not _build.on_card(device):
        return vjp_ordered_plain(pos_k, g_k, pos_j, g_j, mass_k, mass_j,
                                 softening)
    _check_block(block)
    _build.refuse_grad("vjp_ordered", pos_k, g_k, pos_j, g_j, mass_k, mass_j)
    overlap_only = False
    if square_coincident is not None:
        mode = resolve_auto(square_coincident, nk,
                            COINCIDENT_AUTO_MIN_N)
        overlap_only = mode == "fast" or (mode == "auto"
                                          and not any_coincident(pos_k))
    lib = _build.load_library()
    out = torch.empty((nk, 3), dtype=f32, device=device)
    with torch.cuda.device(device):
        code = lib.vjp_ordered_launch(
            pos_k.data_ptr(), g_k.data_ptr(),
            None if mass_k is None else mass_k.data_ptr(), nk,
            pos_j.data_ptr(), g_j.data_ptr(),
            None if mass_j is None else mass_j.data_ptr(), nj,
            out.data_ptr(), float(softening), int(overlap_only), block,
            _build.stream_ptr(device))
    _build.check(lib, code, "vjp_ordered_launch")
    count("launch.B10")
    return out


def vjp_pos_rect(pos_k, g_k, pos_j, g_j, mass_k=None, mass_j=None,
                 softening: float = SOFTENING, block: int = 256):
    """pos_bar rows for a RECTANGULAR slice of the square self-force VJP:
    receivers (pos_k, g_k) summed over the sources (pos_j, g_j), pos_k a
    subset of pos_j's system (the d2 == 0 mask absorbs k's own appearance
    there). Masses both or neither. Every tile masks."""
    if (mass_k is None) != (mass_j is None):
        raise ValueError("vjp_pos_rect needs both masses or neither")
    return _ordered(pos_k, g_k, pos_j, g_j, mass_k, mass_j, softening, block)


def vjp_pos_direct(pos, g, mass=None, softening: float = SOFTENING,
                   block: int = 256, coincident: str = "auto"):
    """pos_bar (N,3) for cotangent g of the square self-force F(pos), every
    ordered pair evaluated (JAX vjp_pos_pallas). coincident: 'masked'
    masks every tile, 'fast' only the tiles whose k and j ranges intersect
    (the only ones that can hold a self pair), 'auto' takes 'fast' unless
    a duplicate scan finds distinct bodies that could coincide. CUDA
    tensors launch B10 with ``block`` threads per block, CPU tensors take
    vjp_ordered_plain (every tile masked)."""
    check_coincident(coincident)
    return _ordered(pos, g, pos, g, mass, mass, softening, block,
                    square_coincident=coincident)


#: B12's tile (csrc/vjp_kernel.cu kPairTile): tile 64 took 62% longer at
#: 262,144 x 262,144 (PERF.md, the B12 sweep).
PAIR_TILE = 128


def vjp_pos_pair_plain(pos_a, g_a, pos_b, mass_a=None, mass_b=None,
                       softening: float = SOFTENING):
    """B12's function in PyTorch (JAX _onesided_grad_block), in row blocks
    of a: with d = p_b - p_a, t = 3 u m_b (g_a.d) d - w m_b g_a (d2 == 0
    masked), returns (a_bar = sum_b t, b_bar = -sum_a t). Only mass_b is
    read; mass_a keeps JAX's signature."""
    na, nb = pos_a.shape[0], pos_b.shape[0]
    rows = max(1, plain_block_elems(pos_a.device) // max(1, nb))
    a_bar, b_bar = [], pos_b.new_zeros((nb, 3))
    for r in range(0, na, rows):
        pa, ga = pos_a[r:r + rows], g_a[r:r + rows]
        d = [pos_b[None, :, k] - pa[:, None, k] for k in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        w, u = _w_u(d2, softening, d2 == 0.0)
        gk = [ga[:, None, k] for k in range(3)]
        dot = gk[0] * d[0] + gk[1] * d[1] + gk[2] * d[2]
        if mass_b is not None:
            mb = mass_b[None, :]
            coeff = 3.0 * (u * mb * dot)
            w = w * mb
        else:
            coeff = 3.0 * (u * dot)
        t = [coeff * dk - w * gkk for dk, gkk in zip(d, gk)]
        a_bar.append(torch.stack([tk.sum(1) for tk in t], -1))
        b_bar -= torch.stack([tk.sum(0) for tk in t], -1)
    if not a_bar:
        return pos_a.new_zeros((0, 3)), b_bar
    return torch.cat(a_bar), b_bar


def pair_operands(pos_a, g_a, pos_b, mass_b, tile):
    """B12's operands padded to whole tiles: pos_a (Na_p, 3) and g_a
    (Na_p, 3), pos_b (Nb_p, 3) or, with mass_b, (Nb_p, 4); pads FAR, with
    zero cotangent and zero mass, so every term against a pad is 0."""
    na, nb = pos_a.shape[0], pos_b.shape[0]
    na_p, nb_p = -(-na // tile) * tile, -(-nb // tile) * tile
    return (_pack(pos_a, None, na, na_p), _pad_rows(g_a.float(), na_p),
            _pack(pos_b, mass_b, nb, nb_p))


def vjp_pos_pair(pos_a, g_a, pos_b, mass_a=None, mass_b=None,
                 softening: float = SOFTENING):
    """Both-sided position cotangents of the ordered pairs (a <- b) with
    receiver cotangents g_a only: (a_bar (Na,3), b_bar (Nb,3)). The 2-D
    grid backward runs it once per device on its (row group, column group)
    tile; a body in both sets meets itself under the d2 == 0 mask. The
    function reads the column masses mass_b only: mass_a (JAX's signature)
    may be left out, and is refused without mass_b; the mass cotangent is
    zero by contract. CUDA tensors launch B12 (one launch per piece of the
    slot table, tile PAIR_TILE), CPU tensors take vjp_pos_pair_plain."""
    if mass_a is not None and mass_b is None:
        raise ValueError("vjp_pos_pair: mass_a without mass_b")
    device = pos_a.device
    na, nb = pos_a.shape[0], pos_b.shape[0]
    f32 = torch.float32
    for name, t, shape in (("pos_a", pos_a, (na, 3)), ("g_a", g_a, (na, 3)),
                           ("pos_b", pos_b, (nb, 3)),
                           ("mass_a", mass_a, (na,)),
                           ("mass_b", mass_b, (nb,))):
        if t is not None:
            _build.check_tensor(name, t, shape, f32, device)
    if not _build.on_card(device):
        return vjp_pos_pair_plain(pos_a, g_a, pos_b, mass_a, mass_b,
                                  softening)
    tile = PAIR_TILE
    _build.refuse_grad("vjp_pos_pair", pos_a, g_a, pos_b, mass_a, mass_b)
    pa, ga, pb = pair_operands(pos_a, g_a, pos_b, mass_b, tile)
    slots = slot_pipe.slot_table(pa.shape[0] // tile, False, True, device,
                                 nb_b=pb.shape[0] // tile)
    acc_a = torch.zeros((pa.shape[0], 3), dtype=f32, device=device)
    acc_b = torch.zeros((pb.shape[0], 3), dtype=f32, device=device)
    lib = _build.load_library()

    def launch(piece, n, _g, _g0, part):
        return lib.vjp_pair_launch(
            piece.data_ptr(), n, pa.data_ptr(), ga.data_ptr(), pb.data_ptr(),
            part.data_ptr(), pb.shape[1], float(softening),
            _build.stream_ptr(device))

    with torch.cuda.device(device):
        slot_pipe.run_slot_pieces("vjp_pair_launch", slots, False, tile, 3,
                                  acc_a, acc_b, launch, "launch.B12")
    return acc_a[:na], acc_b[:nb]


def _pair_terms(p, q, gp, gq, softening, mask, keep=None):
    """Per unordered pair (r, c) of rows p (B,T,3|4) and columns q: the
    three components of t and the mass-cotangent terms -w (g_q.d) (row
    side) and w (g_p.d) (reaction side), each (B,T,T) (JAX
    _pair_grad_block). keep (T,T) bool zeroes the other entries."""
    d = [q[:, None, :, k] - p[:, :, None, k] for k in range(3)]
    dx, dy, dz = d
    d2 = dx * dx + dy * dy + dz * dz
    w, u = _w_u(d2, softening, (d2 == 0.0) if mask else None)
    if keep is not None:
        w = torch.where(keep, w, torch.zeros_like(w))
        u = torch.where(keep, u, torch.zeros_like(u))
    ga = [gp[:, :, None, k] for k in range(3)]
    gb = [gq[:, None, :, k] for k in range(3)]
    dot_a = ga[0] * dx + ga[1] * dy + ga[2] * dz
    dot_b = gb[0] * dx + gb[1] * dy + gb[2] * dz
    if p.shape[-1] == 4:
        ma, mb = p[:, :, None, 3], q[:, None, :, 3]
        coeff = 3.0 * (u * (mb * dot_a - ma * dot_b))
        t = [coeff * dk + w * (ma * gbk - mb * gak)
             for dk, gak, gbk in zip(d, ga, gb)]
    else:
        coeff = 3.0 * (u * (dot_a - dot_b))
        t = [coeff * dk + w * (gbk - gak) for dk, gak, gbk in zip(d, ga, gb)]
    return t, -w * dot_b, w * dot_a


def _side_sums(t, m_row, m_col, ko):
    """(row sums over c, reaction sums over r) of the pair terms, each
    (B,T,ko): the position columns of the reactions are NEGATED (the
    pair's gradient is antisymmetric), the mass column is not."""
    rows = [tk.sum(-1) for tk in t]
    cols = [-tk.sum(-2) for tk in t]
    if ko == 4:
        rows.append(m_row.sum(-1))
        cols.append(m_col.sum(-2))
    return torch.stack(rows, -1), torch.stack(cols, -1)


def vjp_sym_sums_plain(acc_a, acc_b, pos_a, pos_b, g_a, g_b, slots, tile,
                       softening, mask_offdiag, n_sys=1):
    """Plain version of B11 and B9c: for every slot add the row sums into
    acc_a (block bi) and the reaction sums into acc_b (block bj), in batches
    of slots; acc (c, 3), or (c, 4) with the mass cotangent. n_sys systems
    stacked in the rows (tri mode) each take every slot over their own
    blocks, system by system inside each batch of slots."""
    ko, k = acc_a.shape[1], pos_a.shape[1]
    pa, pb = pos_a.view(n_sys, -1, tile, k), pos_b.view(n_sys, -1, tile, k)
    ga, gb = g_a.view(n_sys, -1, tile, 3), g_b.view(n_sys, -1, tile, 3)
    aa = acc_a.view(n_sys, -1, tile, ko)
    ab = acc_b.view(n_sys, -1, tile, ko)
    slots = slots.to(device=pos_a.device, dtype=torch.long)
    batch = max(1, plain_block_elems(pos_a.device) // (tile * tile))
    idx = torch.arange(tile, device=pos_a.device)
    lower = idx[None, :] < idx[:, None]  # [r, c]: c < r
    for kind in (SLOT_DIAG, SLOT_CROSS, SLOT_FOLD):
        sel = slots[slots[:, 0] == kind]
        for s in range(0, sel.shape[0], batch):
            bi, bj = sel[s:s + batch, 1], sel[s:s + batch, 2]
            for y in range(n_sys):
                _vjp_sym_batch(kind, bi, bj, pa[y], pb[y], ga[y], gb[y],
                               aa[y], ab[y], ko, softening, mask_offdiag,
                               lower)


def _vjp_sym_batch(kind, bi, bj, pa, pb, ga, gb, aa, ab, ko, softening,
                   mask_offdiag, lower):
    """One batch of slots of one kind for one system (vjp_sym_sums_plain)."""
    if kind == SLOT_DIAG:
        out = _ordered_rows(pa[bi], ga[bi], pb[bj], gb[bj], softening,
                            mass_rows=ko == 4)
        if ko == 4:
            out = torch.cat([out[0], out[1][..., None]], -1)
        aa.index_add_(0, bi, out)
        return
    if kind == SLOT_CROSS:
        rows, cols = _side_sums(*_pair_terms(
            pa[bi], pb[bj], ga[bi], gb[bj], softening, mask_offdiag), ko)
        aa.index_add_(0, bi, rows)
        ab.index_add_(0, bj, cols)
        return
    # FOLD: pairs of block bi below the diagonal, of bj above it.
    for acc, blk, p, g, keep in ((aa, bi, pa, ga, lower),
                                 (ab, bj, pb, gb, lower.T)):
        rows, cols = _side_sums(*_pair_terms(
            p[blk], p[blk], g[blk], g[blk], softening, mask_offdiag, keep),
            ko)
        acc.index_add_(0, blk, rows + cols)


def _check_sums(acc_a, acc_b, pos_a, pos_b, g_a, g_b, slots, tile):
    """Validate the inputs of vjp_sym_sums_ / vjp_sym_sums_ensemble_."""
    device = pos_a.device
    k, ko = pos_a.shape[1], acc_a.shape[1]
    if k not in (3, 4) or ko not in (3, 4) or (ko == 4 and k != 4):
        raise ValueError(f"packed positions have 3 or 4 columns and the "
                         f"accumulators 3, or 4 in mass mode; got {k}, {ko}")
    for name, t, width in (("pos_a", pos_a, k), ("pos_b", pos_b, k),
                           ("g_a", g_a, 3), ("g_b", g_b, 3),
                           ("acc_a", acc_a, ko), ("acc_b", acc_b, ko)):
        if t.shape[0] % tile != 0:
            raise ValueError(f"{name} rows {t.shape[0]} are not a multiple "
                             f"of tile {tile}")
        _build.check_tensor(name, t, (t.shape[0], width), torch.float32,
                            device)
    for a, p, g in ((acc_a, pos_a, g_a), (acc_b, pos_b, g_b)):
        if not a.shape[0] == p.shape[0] == g.shape[0]:
            raise ValueError("each accumulator needs the rows of its bodies")
    _build.check_tensor("slots", slots, (slots.shape[0], 3), torch.int32,
                        device)


def _run_sym_kernel(kind, acc_a, acc_b, pos_a, pos_b, g_a, g_b, slots, tile,
                    softening, mask_offdiag, n_sys=1, sys_rows=0):
    """B11 on the card ("tri" or "cross" calls) or B9c ("ensemble": n_sys
    systems of sys_rows rows, tri mode)."""
    if tile not in SYM_BWD_TILES:
        raise ValueError(f"the CUDA pair-once VJP kernel takes tile in "
                         f"{SYM_BWD_TILES}, got {tile}")
    _build.refuse_grad("vjp_sym_sums_", pos_a, pos_b, g_a, g_b)
    lib = _build.load_library()
    device = pos_a.device
    k, ko = pos_a.shape[1], acc_a.shape[1]

    def launch(piece, n, g, g0, part):
        r0 = g0 * sys_rows
        return lib.vjp_sym_launch(
            piece.data_ptr(), n, g, sys_rows, pos_a[r0:].data_ptr(),
            pos_b[r0:].data_ptr(), g_a[r0:].data_ptr(), g_b[r0:].data_ptr(),
            part.data_ptr(), k, ko, tile, float(softening),
            int(mask_offdiag), _build.stream_ptr(device))

    with torch.cuda.device(device):
        slot_pipe.run_slot_pieces("vjp_sym_launch", slots, kind != "cross",
                                  tile, ko, acc_a, acc_b, launch,
                                  SYM_COUNTERS[kind], n_sys, sys_rows)


def vjp_sym_sums_(acc_a, acc_b, pos_a, pos_b, g_a, g_b, slots, tile,
                  softening, mask_offdiag=True):
    """Add the pair-once VJP sums of one self chunk (tri mode: acc_a and
    acc_b the same memory, pos_a is pos_b, a tri slot table) or one pair of
    disjoint sets (cross mode: rows into acc_a, reactions into acc_b, a
    cross table). pos (c, 3|4) packed as K3's, g (c, 3), acc (c, 3|4)."""
    _check_sums(acc_a, acc_b, pos_a, pos_b, g_a, g_b, slots, tile)
    if not _build.on_card(pos_a.device):
        vjp_sym_sums_plain(acc_a, acc_b, pos_a, pos_b, g_a, g_b, slots, tile,
                           softening, mask_offdiag)
        return
    cross = acc_a.data_ptr() != acc_b.data_ptr()
    _run_sym_kernel("cross" if cross else "tri", acc_a, acc_b, pos_a, pos_b,
                    g_a, g_b, slots, tile, softening, mask_offdiag)


def vjp_sym_sums_ensemble_(acc, pos, g, slots, tile, softening, n_sys,
                           mask_offdiag=True):
    """B independent self chunks (B9c): systems of c = rows / n_sys rows
    stacked in pos (B c, 3|4), g (B c, 3) and acc (B c, 3|4), each summed
    over the same tri ``slots`` into its own rows. System i's sums are
    bitwise those of vjp_sym_sums_ on its rows alone, on the card (one
    kernel, the same pieces) and on the CPU (the same plain walk)."""
    rows = pos.shape[0]
    if n_sys < 1 or rows % n_sys != 0:
        raise ValueError(f"{rows} rows do not split into {n_sys} systems")
    c = rows // n_sys
    _check_sums(acc, acc, pos, pos, g, g, slots, tile)
    if c % tile != 0:
        raise ValueError(f"a system has {c} rows, not a multiple of tile "
                         f"{tile}")
    if not _build.on_card(pos.device):
        vjp_sym_sums_plain(acc, acc, pos, pos, g, g, slots, tile, softening,
                           mask_offdiag, n_sys)
        return
    _run_sym_kernel("ensemble", acc, acc, pos, pos, g, g, slots, tile,
                    softening, mask_offdiag, n_sys, c)


def _pad_rows(t, np_):
    """Zero-pad t's rows to np_."""
    if t.shape[0] == np_:
        return t.contiguous()
    return torch.cat([t, t.new_zeros((np_ - t.shape[0], *t.shape[1:]))])


def chunk_loop(run, acc, bodies, tile, c, nc):
    """The pair-once chunk loop of K3 (body_force_symmetric) over per-body
    tensors ``bodies`` (each (Np, .)): run(acc_a, acc_b, a, b, slots) once
    per self chunk (a is b, a tri table) and once per chunk pair a < b (a
    cross table), a and b the lists of the chunks' slices."""
    nb = c // tile
    tri = slot_pipe.slot_table(nb, nb > 1, False, acc.device)
    chunks = [slice(a * c, (a + 1) * c) for a in range(nc)]
    for sl in chunks:
        part = [t[sl] for t in bodies]
        run(acc[sl], acc[sl], part, part, tri)
    if nc > 1:
        cross = slot_pipe.slot_table(nb, False, True, acc.device)
        for a in range(nc):
            for b in range(a + 1, nc):
                sa, sb = chunks[a], chunks[b]
                run(acc[sa], acc[sb], [t[sa] for t in bodies],
                    [t[sb] for t in bodies], cross)


def vjp_pos_sym(pos, g, mass=None, softening: float = SOFTENING,
                tile: int | None = None, chunk: int = 131072,
                mass_grad: bool = False, coincident: str = "auto"):
    """pos_bar (N,3) for cotangent g of the square self-force, each
    unordered pair computed once; with mass_grad (masses required) also
    mass_bar (N,): returns (pos_bar, mass_bar).

    coincident: the off-diagonal d2 == 0 mask, as in the forward: 'auto'
    runs a duplicate scan (a host sync) and drops the mask when no two
    distinct bodies can coincide, 'masked' always masks, 'fast' never
    does; DIAG slots (self pairs) always mask. CUDA tensors run B11 (tile
    64 or 128), CPU tensors its plain version."""
    if mass_grad and mass is None:
        raise ValueError("mass_grad=True requires per-body masses")
    check_coincident(coincident)
    n = pos.shape[0]
    tile, c, nc, np_ = _resolve_tiling(
        n, DEFAULT_TILE if tile is None else tile, chunk,
        kernel=_build.on_card(pos.device))
    coincident = resolve_auto(coincident, n, SYM_COINCIDENT_AUTO_MIN_N)
    if coincident == "auto":
        mask_offdiag = any_coincident(pos)
    else:
        mask_offdiag = coincident == "masked"
    p = _pack(pos, mass, n, np_)
    gp = _pad_rows(g.float(), np_)
    acc = torch.zeros((np_, 4 if mass_grad else 3), dtype=torch.float32,
                      device=p.device)

    def run(acc_a, acc_b, a, b, slots):
        vjp_sym_sums_(acc_a, acc_b, a[0], b[0], a[1], b[1], slots, tile,
                      softening, mask_offdiag)

    chunk_loop(run, acc, (p, gp), tile, c, nc)
    if mass_grad:
        return acc[:n, :3], acc[:n, 3]
    return acc[:n]


def check_ensemble_vjp(pos, g, mass, mass_grad):
    """The argument checks of the ensemble VJPs (JAX's messages)."""
    if mass_grad and mass is None:
        raise ValueError("mass_grad=True requires per-body masses")
    if pos.ndim != 3:
        raise ValueError(f"ensemble pos must be (B, N, 3), got "
                         f"{tuple(pos.shape)}")
    if tuple(g.shape) != tuple(pos.shape):
        raise ValueError(f"ensemble g must be (B, N, 3) = "
                         f"{tuple(pos.shape)}, got {tuple(g.shape)}")


def ensemble_mask(coincident, pos, gate):
    """The off-diagonal mask of an ensemble VJP: resolve_auto at the
    per-system N against the module's gate, then for 'auto' the duplicate
    scan within each system."""
    coincident = resolve_auto(coincident, pos.shape[1], gate)
    if coincident == "auto":
        return any_coincident_ensemble(pos)
    return coincident == "masked"


def pad_systems(g, c):
    """Zero-pad each system of g (B, N, 3) to c rows, stacked (B c, 3)."""
    b, n = g.shape[0], g.shape[1]
    g = g.float()
    if c != n:
        g = torch.cat([g, g.new_zeros((b, c - n, 3))], dim=1)
    return g.reshape(b * c, 3).contiguous()


def vjp_pos_sym_ensemble(pos, g, mass=None, softening: float = SOFTENING,
                         tile: int | None = None, mass_grad: bool = False,
                         coincident: str = "auto"):
    """pos_bar (B, N, 3) for cotangent g (B, N, 3) of the forces of B
    INDEPENDENT systems pos (B, N, 3) [, mass (B, N)], each unordered pair
    of a system once (B9c); with mass_grad (masses required) returns
    (pos_bar, mass_bar (B, N)). Each system is one chunk of c =
    round_up(N, t) rows with its own FAR pads, t = tile (this module's
    DEFAULT_TILE when None; shrunk to the problem on the CPU): system i is
    bitwise ``vjp_pos_sym(pos[i], g[i], mass[i], tile=t, chunk=c)``.
    coincident as in vjp_pos_sym; 'auto' scans within each system only.
    CUDA tensors run the kernel, CPU tensors its plain version."""
    check_ensemble_vjp(pos, g, mass, mass_grad)
    check_coincident(coincident)
    b, n = pos.shape[0], pos.shape[1]
    t, c = ensemble_tiling(n, DEFAULT_TILE if tile is None else tile,
                           kernel=_build.on_card(pos.device))
    mask_offdiag = ensemble_mask(coincident, pos, SYM_COINCIDENT_AUTO_MIN_N)
    p = pack_ensemble(pos, mass, c, _pack)
    gp = pad_systems(g, c)
    acc = torch.zeros((b * c, 4 if mass_grad else 3), dtype=torch.float32,
                      device=p.device)
    nb = c // t
    vjp_sym_sums_ensemble_(acc, p, gp, slot_pipe.slot_table(
        nb, nb > 1, False, p.device), t, softening, b, mask_offdiag)
    acc = acc.view(b, c, -1)[:, :n]
    if mass_grad:
        return acc[..., :3], acc[..., 3]
    return acc
