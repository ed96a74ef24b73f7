"""The force VJP in the bf16 class: pair-once (B13) and rectangular (B14),
the backward of the ``sym_mxu`` forward.

Counterpart of ``mini_nbody_tpu/ops/vjp_mxu.py`` (``:74-109`` _wc_block,
``:112-131`` _row_sums / _col_sums, ``:134-221`` the two kernels,
``:224-245`` _split8 / _combine, ``:263-383`` vjp_pos_sym_mxu, ``:531-700``
vjp_rect_mxu). With d = p_b - p_a, s = |d|^2 + eps, w = s^-3/2, u = s^-5/2,
a pair's gradient term to a (and -1x to b) is

    t = w (m_a g_b - m_b g_a) + c d,   c = 3 u (m_b (g_a.d) - m_a (g_b.d)).

Only the scalars w and c depend on both bodies, so every sum of t is two
products against per-body operands, A_g = [g | m] and A_p = [p | 1]:

    rows:      S_g = W @ A_g,  S_p = C @ A_p
    reactions: S_g = W^T @ A_g,  S_p = C^T @ A_p   (the minus is in the
               transposed contraction: -t = w (m_b g_a - m_a g_b) + c (p_a
               - p_b))
    pos_bar = m S_g[:3] - g S_g[3] + S_p[:3] - p S_p[3]     (_combine)

so rows and reactions add into one (Np, 8) accumulator [S_g | S_p] and the
combine runs once. w and c are fp32; the products take them and the
operands in bf16 (the operands split into compensated [hi | lo] halves,
_split8) with fp32 accumulation: the bf16 error class of the forward. The
mass cotangent, -w (g_b.d) to a and +w (g_a.d) to b, is a 9th column summed
in fp32.

- ``vjp_pos_sym_mxu`` launches B13 (``csrc/vjp_mxu.cu``) on K2's slot +
  fold geometry and the chunk loop of K3, summing deterministically
  (``slot_pipe.run_slot_pieces``); CPU tensors take ``vjp_mxu_sums_plain``.
- ``vjp_rect_mxu`` launches B14 (same source), B13's row half on a full
  rectangular grid, with w and c packed straight into ``mma.sync``
  fragments (the kernel forms the split operands of each staged body
  itself); CPU tensors take ``vjp_rect_mxu_plain``.

The plain versions compute w and c in fp32 in the kernels' order of
operations; ``mma_dtype=torch.float32`` multiplies in fp32 (JAX's CPU
interpret run) and ``torch.bfloat16`` rounds w, c and the operands to bf16
as the tensor cores do. Pads are FAR in both mass modes (zero mass in mass
mode, unit mass otherwise) with zero cotangents; the self diagonal always
masks.

``vjp_pos_sym_mxu_ensemble`` (JAX ``:386-528``) launches B9d: B13 with the
system on ``blockIdx.y``, B systems of c = round_up(N, tile) rows stacked,
each its own chunk over the same tri slot list with its own operands
(``vjp_mxu_sums_ensemble_``). System i is bitwise ``vjp_pos_sym_mxu(pos[i],
g[i], mass[i], tile=t)`` for N up to the chunk. Its plain version is
``vjp_mxu_sums_plain`` with the system axis.
"""

from __future__ import annotations

import math

import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.ops import slot_pipe
from mini_nbody_tpu_torch.ops.slot_pipe import SLOT_CROSS, SLOT_DIAG, SLOT_FOLD
from mini_nbody_tpu_torch.ops.sym_mxu_force import (_resolve_tiling,
                                                    any_coincident,
                                                    ensemble_tiling,
                                                    pack_ensemble,
                                                    resolve_auto)
from mini_nbody_tpu_torch.ops.symmetric_force import _pack
from mini_nbody_tpu_torch.ops.vjp_kernel import (_pad_rows, check_ensemble_vjp,
                                                 chunk_loop, ensemble_mask,
                                                 pad_systems)
from mini_nbody_tpu_torch.utils.config import (SOFTENING, SYM_BWD_TILES,
                                               check_coincident,
                                               plain_block_elems)
from mini_nbody_tpu_torch.utils.tracing import count

#: Tile of the pair-once backward when the caller names none, and of the
#: rectangular one. With w and c in mma.sync fragments one call at N =
#: 65,536 with masses took 3.95-4.21 ms at 128 and 5.27 ms at 64, and the
#: 16 x 65,536 ensemble backward (B9d) 63.8 ms against 83.2-83.3
#: (ab_slots.py --only pvjp, NVIDIA H100 80GB HBM3 at 700 W); the
#: shared-tile kernel before them (64,000 bytes of shared memory at 64,
#: 177,152 at 128) took 13.86 ms at 128 and 39.59 at 64.
DEFAULT_TILE = 128
RECT_TILE = 128


def rect_threads(tile: int) -> int:
    """Threads per CTA of B14 at ``tile`` (csrc/vjp_mxu.cu ``rect_threads``,
    the count ``vjp_rect_mxu_info`` reports): one warp per 16-row strip of
    the tile's receivers, warp w's lane l owning rows 16 w + l / 4 and that
    + 8 of every m16n8k16 step."""
    return 2 * tile


#: The registry's counters (utils/tracing.count), counted at each launch
#: on CUDA tensors: vjp_mxu_sums_ (B13) and vjp_mxu_sums_ensemble_ (B9d)
#: count COUNTERS by kind, one per piece of the slot list and group of
#: systems (slot_pipe.run_slot_pieces); vjp_rect_mxu counts launch.B14, one
#: per call.
COUNTERS = {"tri": "launch.B13.tri", "cross": "launch.B13.cross",
            "ensemble": "launch.B9d"}

#: The coincident gates: below this many bodies 'auto' is 'masked', without
#: the duplicate scan. chip_smoke.py's coincident_gate phase (4096 ..
#: 262,144, an H100): the scan pays for B14 from 131,072 on
#: (COINCIDENT_AUTO_MIN_N); for B13 at no measured
#: N, its maskless kernel being no faster, so B13's 'auto' is 'masked' at
#: every N (SYM_COINCIDENT_AUTO_MIN_N infinite).
COINCIDENT_AUTO_MIN_N = 131072
SYM_COINCIDENT_AUTO_MIN_N = math.inf


def _split8(v):
    """Compensated [vhi | vlo] operand: vhi = bf16(v), vlo = v - vhi."""
    vhi = v.to(torch.bfloat16).float()
    return torch.cat([vhi, v - vhi], dim=-1)


def _operands(p, g):
    """(N, 16) per-body operands [split8([g | m]) | split8([p | 1])] of
    packed positions p (N, 3|4; unit masses without the 4th column)."""
    one = p.new_ones((p.shape[0], 1))
    m = p[:, 3:4] if p.shape[1] == 4 else one
    return torch.cat([_split8(torch.cat([g, m], 1)),
                      _split8(torch.cat([p[:, :3], one], 1))], 1).contiguous()


def _combine(total, mf, gf, posf):
    """pos_bar = m S_g[:3] - g S_g[3] + S_p[:3] - p S_p[3] from the (., 8)
    sums, each product rounded on its own and the chain in JAX's order."""
    sg, sp = total[:, 0:4], total[:, 4:8]
    t_m = mf[:, None] * sg[:, 0:3]
    t_g = gf * sg[:, 3:4]
    t_p = posf * sp[:, 3:4]
    return t_m - t_g + sp[:, 0:3] - t_p


def _wc(p, q, gp, gq, softening, mask, keep=None):
    """fp32 w and c for rows p (..., R, 3|4) against columns q (..., J,
    3|4), in the kernels' order of operations (JAX _wc_block), with the
    mass-cotangent terms -w (g_q.d) (row side) and w (g_p.d) (reaction
    side). keep zeroes the other entries."""
    dx = q[..., None, :, 0] - p[..., :, None, 0]
    dy = q[..., None, :, 1] - p[..., :, None, 1]
    dz = q[..., None, :, 2] - p[..., :, None, 2]
    d2 = dx * dx + dy * dy + dz * dz
    inv = torch.rsqrt(d2 + softening)
    inv2 = inv * inv
    w = inv2 * inv
    u = w * inv2
    if mask:
        w = torch.where(d2 == 0.0, torch.zeros_like(w), w)
        u = torch.where(d2 == 0.0, torch.zeros_like(u), u)
    if keep is not None:
        w = torch.where(keep, w, torch.zeros_like(w))
        u = torch.where(keep, u, torch.zeros_like(u))
    dot_a = (gp[..., :, None, 0] * dx + gp[..., :, None, 1] * dy
             + gp[..., :, None, 2] * dz)
    dot_b = (gq[..., None, :, 0] * dx + gq[..., None, :, 1] * dy
             + gq[..., None, :, 2] * dz)
    if p.shape[-1] == 4:
        c = 3.0 * (u * (q[..., None, :, 3] * dot_a - p[..., :, None, 3] * dot_b))
    else:
        c = 3.0 * (u * (dot_a - dot_b))
    return w, c, -w * dot_b, w * dot_a


def _mm(a, b, transpose, mma_dtype):
    """a @ b (or a^T @ b) over batches; bf16 mode rounds both operands."""
    if mma_dtype == torch.bfloat16:
        a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    return torch.matmul(a.transpose(-1, -2) if transpose else a, b)


def _fold(r):
    """(..., 8) [hi | lo] product -> (..., 4)."""
    return r[..., 0:4] + r[..., 4:8]


def _sums(w, c, q, transpose, mma_dtype):
    """(B, T, 8) [S_g | S_p] of one side from the (B, T, 16) operands."""
    return torch.cat([_fold(_mm(w, q[..., 0:8], transpose, mma_dtype)),
                      _fold(_mm(c, q[..., 8:16], transpose, mma_dtype))], -1)


def vjp_mxu_sums_plain(acc_a, acc_b, pos_a, pos_b, g_a, g_b, q_a, q_b, slots,
                       tile, softening, mask_offdiag,
                       mma_dtype=torch.float32, n_sys=1):
    """Plain version of B13 and B9d: for every slot add the row sums into
    acc_a (block bi) and the reaction sums into acc_b (block bj), in batches
    of slots; acc (c, 8), or (c, 9) with the mass cotangent. n_sys systems
    stacked in the rows (tri mode) each take every slot over their own
    blocks, system by system inside each batch of slots."""
    ko, k = acc_a.shape[1], pos_a.shape[1]
    view = lambda t, w: t.view(n_sys, -1, tile, w)  # noqa: E731
    pa, pb, ga, gb = view(pos_a, k), view(pos_b, k), view(g_a, 3), view(g_b, 3)
    qa, qb = view(q_a, 16), view(q_b, 16)
    aa, ab = view(acc_a, ko), view(acc_b, ko)
    slots = slots.to(device=pos_a.device, dtype=torch.long)
    batch = max(1, plain_block_elems(pos_a.device) // (tile * tile))
    idx = torch.arange(tile, device=pos_a.device)
    lower = idx[None, :] < idx[:, None]  # [r, c]: c < r
    for kind in (SLOT_DIAG, SLOT_CROSS, SLOT_FOLD):
        sel = slots[slots[:, 0] == kind]
        for s in range(0, sel.shape[0], batch):
            bi, bj = sel[s:s + batch, 1], sel[s:s + batch, 2]
            for y in range(n_sys):
                _vjp_mxu_batch(kind, bi, bj, pa[y], pb[y], ga[y], gb[y],
                               qa[y], qb[y], aa[y], ab[y], ko, softening,
                               mask_offdiag, mma_dtype, lower)


def _vjp_mxu_batch(kind, bi, bj, pa, pb, ga, gb, qa, qb, aa, ab, ko,
                   softening, mask_offdiag, mma_dtype, lower):
    """One batch of slots of one kind for one system (vjp_mxu_sums_plain)."""
    def with_mass(s, m):
        return torch.cat([s, m[..., None]], -1) if ko == 9 else s

    if kind != SLOT_FOLD:
        w, c, m_row, m_col = _wc(pa[bi], pb[bj], ga[bi], gb[bj], softening,
                                 kind == SLOT_DIAG or mask_offdiag)
        aa.index_add_(0, bi, with_mass(
            _sums(w, c, qb[bj], False, mma_dtype), m_row.sum(-1)))
        if kind == SLOT_CROSS:
            ab.index_add_(0, bj, with_mass(
                _sums(w, c, qa[bi], True, mma_dtype), m_col.sum(-2)))
        return
    # FOLD: pairs of block bi below the diagonal, of bj above it.
    for acc, blk, p, g, q, keep in ((aa, bi, pa, ga, qa, lower),
                                    (ab, bj, pb, gb, qb, lower.T)):
        w, c, m_row, m_col = _wc(p[blk], p[blk], g[blk], g[blk], softening,
                                 mask_offdiag, keep)
        acc.index_add_(0, blk, with_mass(
            _sums(w, c, q[blk], False, mma_dtype)
            + _sums(w, c, q[blk], True, mma_dtype),
            m_row.sum(-1) + m_col.sum(-2)))


def _check_sums(acc_a, acc_b, pos_a, pos_b, g_a, g_b, q_a, q_b, slots, tile):
    """Validate the inputs of vjp_mxu_sums_ / vjp_mxu_sums_ensemble_."""
    device = pos_a.device
    k, ko = pos_a.shape[1], acc_a.shape[1]
    if k not in (3, 4) or ko not in (8, 9) or (ko == 9 and k != 4):
        raise ValueError(f"packed positions have 3 or 4 columns and the "
                         f"accumulators 8, or 9 in mass mode; got {k}, {ko}")
    for name, t, width in (("pos_a", pos_a, k), ("pos_b", pos_b, k),
                           ("g_a", g_a, 3), ("g_b", g_b, 3),
                           ("q_a", q_a, 16), ("q_b", q_b, 16),
                           ("acc_a", acc_a, ko), ("acc_b", acc_b, ko)):
        if t.shape[0] % tile != 0:
            raise ValueError(f"{name} rows {t.shape[0]} are not a multiple "
                             f"of tile {tile}")
        _build.check_tensor(name, t, (t.shape[0], width), torch.float32,
                            device)
    for a, p, g, q in ((acc_a, pos_a, g_a, q_a), (acc_b, pos_b, g_b, q_b)):
        if not a.shape[0] == p.shape[0] == g.shape[0] == q.shape[0]:
            raise ValueError("each accumulator needs the rows of its bodies")
    _build.check_tensor("slots", slots, (slots.shape[0], 3), torch.int32,
                        device)


def _run_kernel(kind, acc_a, acc_b, pos_a, pos_b, g_a, g_b, q_a, q_b, slots,
                tile, softening, mask_offdiag, n_sys=1, sys_rows=0):
    """B13 on the card ("tri" or "cross" calls) or B9d ("ensemble": n_sys
    systems of sys_rows rows, tri mode)."""
    if tile not in SYM_BWD_TILES:
        raise ValueError(f"the CUDA pair-once VJP kernel takes tile in "
                         f"{SYM_BWD_TILES}, got {tile}")
    _build.refuse_grad("vjp_mxu_sums_", pos_a, pos_b, g_a, g_b, q_a, q_b)
    lib = _build.load_library()
    device = pos_a.device
    k, ko = pos_a.shape[1], acc_a.shape[1]

    def launch(piece, n, g, g0, part):
        r0 = g0 * sys_rows
        return lib.vjp_mxu_launch(
            piece.data_ptr(), n, g, sys_rows, pos_a[r0:].data_ptr(),
            pos_b[r0:].data_ptr(), g_a[r0:].data_ptr(), g_b[r0:].data_ptr(),
            q_a[r0:].data_ptr(), q_b[r0:].data_ptr(), part.data_ptr(),
            int(k == 4), ko, tile, float(softening), int(mask_offdiag),
            _build.stream_ptr(device))

    with torch.cuda.device(device):
        slot_pipe.run_slot_pieces("vjp_mxu_launch", slots, kind != "cross",
                                  tile, ko, acc_a, acc_b, launch,
                                  COUNTERS[kind], n_sys, sys_rows)


def vjp_mxu_sums_(acc_a, acc_b, pos_a, pos_b, g_a, g_b, q_a, q_b, slots,
                  tile, softening, mask_offdiag=True):
    """Add B13's raw sums of one self chunk (tri mode: acc_a and acc_b the
    same memory, pos_a is pos_b, a tri slot table) or one chunk pair (cross
    mode). pos (c, 3|4) packed as K3's, g (c, 3), q (c, 16) from
    _operands, acc (c, 8|9)."""
    _check_sums(acc_a, acc_b, pos_a, pos_b, g_a, g_b, q_a, q_b, slots, tile)
    if not _build.on_card(pos_a.device):
        vjp_mxu_sums_plain(acc_a, acc_b, pos_a, pos_b, g_a, g_b, q_a, q_b,
                           slots, tile, softening, mask_offdiag)
        return
    cross = acc_a.data_ptr() != acc_b.data_ptr()
    _run_kernel("cross" if cross else "tri", acc_a, acc_b, pos_a, pos_b, g_a,
                g_b, q_a, q_b, slots, tile, softening, mask_offdiag)


def vjp_mxu_sums_ensemble_(acc, pos, g, q, slots, tile, softening, n_sys,
                           mask_offdiag=True):
    """B independent self chunks (B9d): systems of c = rows / n_sys rows
    stacked in pos (B c, 3|4), g (B c, 3), q (B c, 16) and acc (B c, 8|9),
    each summed over the same tri ``slots`` into its own rows. System i's
    sums are bitwise those of vjp_mxu_sums_ on its rows alone, on the card
    (one kernel, the same pieces) and on the CPU (the same plain walk)."""
    rows = pos.shape[0]
    if n_sys < 1 or rows % n_sys != 0:
        raise ValueError(f"{rows} rows do not split into {n_sys} systems")
    c = rows // n_sys
    _check_sums(acc, acc, pos, pos, g, g, q, q, slots, tile)
    if c % tile != 0:
        raise ValueError(f"a system has {c} rows, not a multiple of tile "
                         f"{tile}")
    if not _build.on_card(pos.device):
        vjp_mxu_sums_plain(acc, acc, pos, pos, g, g, q, q, slots, tile,
                           softening, mask_offdiag, n_sys=n_sys)
        return
    _run_kernel("ensemble", acc, acc, pos, pos, g, g, q, q, slots, tile,
                softening, mask_offdiag, n_sys, c)


def sums_inputs(pos, g, mass=None, tile: int | None = None,
                chunk: int = 131072):
    """The tiling (tile, chunk c, chunks nc, padded Np) and the padded
    inputs (packed positions p (Np, 3|4), cotangents gp (Np, 3), operands
    q (Np, 16)) of B13's raw sums, as vjp_pos_sym_mxu feeds them to
    vjp_mxu_sums_."""
    n = pos.shape[0]
    tiling = _resolve_tiling(n, DEFAULT_TILE if tile is None else tile,
                             chunk, kernel=_build.on_card(pos.device))
    np_ = tiling[3]
    p = _pack(pos, mass, n, np_)
    gp = _pad_rows(g.float(), np_)
    return tiling, (p, gp, _operands(p, gp))


def vjp_pos_sym_mxu(pos, g, mass=None, softening: float = SOFTENING,
                    tile: int | None = None, chunk: int = 131072,
                    mass_grad: bool = False, coincident: str = "auto"):
    """pos_bar (N,3) for cotangent g of the square self-force through the
    bf16-class pair-once backward; with mass_grad (masses required) returns
    (pos_bar, mass_bar). coincident as in vjp_kernel.vjp_pos_sym; DIAG
    slots and the fold's self diagonal always mask. CUDA tensors run B13
    (tile 64 or 128), CPU tensors its plain version in fp32."""
    if mass_grad and mass is None:
        raise ValueError("mass_grad=True requires per-body masses")
    check_coincident(coincident)
    n = pos.shape[0]
    (tile, c, nc, np_), (p, gp, q) = sums_inputs(pos, g, mass, tile, chunk)
    coincident = resolve_auto(coincident, n, SYM_COINCIDENT_AUTO_MIN_N)
    if coincident == "auto":
        mask_offdiag = any_coincident(pos)
    else:
        mask_offdiag = coincident == "masked"
    acc = torch.zeros((np_, 9 if mass_grad else 8), dtype=torch.float32,
                      device=p.device)

    def run(acc_a, acc_b, a, b, slots):
        vjp_mxu_sums_(acc_a, acc_b, a[0], b[0], a[1], b[1], a[2], b[2],
                      slots, tile, softening, mask_offdiag)

    chunk_loop(run, acc, (p, gp, q), tile, c, nc)
    mf = p[:, 3] if mass is not None else p.new_ones(np_)
    pos_bar = _combine(acc[:, :8], mf, gp, p[:, :3])[:n]
    if mass_grad:
        return pos_bar, acc[:n, 8]
    return pos_bar


def ensemble_sums_inputs(pos, g, mass=None, tile: int | None = None):
    """The tiling (tile t, per-system rows c) and the stacked padded inputs
    (p (B c, 3|4), gp (B c, 3), q (B c, 16)) of B9d's raw sums: each system
    padded and packed as sums_inputs pads and packs it alone."""
    t, c = ensemble_tiling(pos.shape[1], DEFAULT_TILE if tile is None
                           else tile, kernel=_build.on_card(pos.device))
    p = pack_ensemble(pos, mass, c, _pack)
    gp = pad_systems(g, c)
    return (t, c), (p, gp, _operands(p, gp))


def vjp_pos_sym_mxu_ensemble(pos, g, mass=None, softening: float = SOFTENING,
                             tile: int | None = None, mass_grad: bool = False,
                             coincident: str = "auto"):
    """pos_bar (B, N, 3) for cotangent g (B, N, 3) of the forces of B
    INDEPENDENT systems pos (B, N, 3) [, mass (B, N)] through the bf16-class
    pair-once backward (B9d); with mass_grad (masses required) returns
    (pos_bar, mass_bar (B, N)). Each system is one chunk of c =
    round_up(N, t) rows with its own FAR pads and operands, t = tile (this
    module's DEFAULT_TILE when None; shrunk to the problem on the CPU):
    system i is bitwise ``vjp_pos_sym_mxu(pos[i], g[i], mass[i], tile=t,
    chunk=c)``. coincident as in vjp_pos_sym_mxu; 'auto' scans within each
    system only. CUDA tensors run the kernel, CPU tensors its plain version
    in fp32."""
    check_ensemble_vjp(pos, g, mass, mass_grad)
    check_coincident(coincident)
    b, n = pos.shape[0], pos.shape[1]
    (t, c), (p, gp, q) = ensemble_sums_inputs(pos, g, mass, tile)
    mask_offdiag = ensemble_mask(coincident, pos, SYM_COINCIDENT_AUTO_MIN_N)
    acc = torch.zeros((b * c, 9 if mass_grad else 8), dtype=torch.float32,
                      device=p.device)
    nb = c // t
    vjp_mxu_sums_ensemble_(acc, p, gp, q, slot_pipe.slot_table(
        nb, nb > 1, False, p.device), t, softening, b, mask_offdiag)
    mf = p[:, 3] if mass is not None else p.new_ones(b * c)
    pos_bar = _combine(acc[:, :8], mf, gp, p[:, :3]).view(b, c, 3)[:, :n]
    if mass_grad:
        return pos_bar, acc[:, 8].view(b, c)[:, :n]
    return pos_bar


def vjp_rect_mxu_plain(pos_k, g_k, pos_j, g_j, mass_k=None, mass_j=None,
                       softening: float = SOFTENING, mma_dtype=torch.float32):
    """B14's arithmetic in PyTorch, every block masked: the raw row sums
    (Nk, 8) [S_g | S_p] of receivers (pos_k, g_k) over the sources."""
    pk, pj = pos_k, pos_j
    if mass_k is not None:
        pk = torch.cat([pos_k, mass_k[:, None]], 1)
        pj = torch.cat([pos_j, mass_j[:, None]], 1)
    qj = _operands(pj, g_j)
    rows = max(1, plain_block_elems(pos_k.device) // max(1, pj.shape[0]))
    out = []
    for r in range(0, pk.shape[0], rows):
        w, c, _, _ = _wc(pk[r:r + rows], pj, g_k[r:r + rows], g_j, softening,
                         True)
        out.append(_sums(w, c, qj, False, mma_dtype))
    if not out:
        return pos_k.new_zeros((0, 8))
    return torch.cat(out)


def vjp_rect_mxu_rows(pos_k, g_k, pos_j, g_j, mass_k=None, mass_j=None,
                      softening: float = SOFTENING, tile: int = RECT_TILE,
                      square_coincident=None):
    """B14's raw row sums (Nk, 8): CUDA tensors launch the kernel, CPU
    tensors take vjp_rect_mxu_plain. square_coincident: the coincident mode
    of a square call (tiles whose k and j ranges do not intersect drop the
    d2 == 0 select when no two distinct bodies coincide); None masks every
    tile."""
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
        return vjp_rect_mxu_plain(pos_k, g_k, pos_j, g_j, mass_k, mass_j,
                                  softening)
    if tile not in SYM_BWD_TILES:
        raise ValueError(f"the CUDA rectangular VJP kernel takes tile in "
                         f"{SYM_BWD_TILES}, got {tile}")
    _build.refuse_grad("vjp_rect_mxu", pos_k, g_k, pos_j, g_j, mass_k, mass_j)
    overlap_only = False
    if square_coincident is not None:
        mode = resolve_auto(square_coincident, nk,
                            COINCIDENT_AUTO_MIN_N)
        overlap_only = mode == "fast" or (mode == "auto"
                                          and not any_coincident(pos_k))
    masses = mass_k is not None
    pk = torch.cat([pos_k, mass_k[:, None]], 1) if masses else pos_k
    pj = torch.cat([pos_j, mass_j[:, None]], 1) if masses else pos_j
    lib = _build.load_library()
    rows = torch.empty((nk, 8), dtype=f32, device=device)
    with torch.cuda.device(device):
        code = lib.vjp_rect_mxu_launch(
            pk.data_ptr(), g_k.data_ptr(), nk, pj.data_ptr(),
            g_j.data_ptr(), nj, rows.data_ptr(), int(masses), tile,
            float(softening), int(overlap_only), _build.stream_ptr(device))
    _build.check(lib, code, "vjp_rect_mxu_launch")
    count("launch.B14")
    return rows


def vjp_rect_mxu(pos_k, g_k, pos_j, g_j, mass_k=None, mass_j=None,
                 softening: float = SOFTENING, tile: int = RECT_TILE,
                 coincident: str = "masked"):
    """pos_bar rows (Nk, 3) for a RECTANGULAR slice of the square
    self-force VJP through the bf16-class backward: receivers (pos_k, g_k)
    over sources (pos_j, g_j), pos_k a subset of pos_j's system. Masses
    both or neither. coincident applies to SQUARE calls only (pos_j is
    pos_k, the autodiff branch beyond its bound): 'auto' and 'fast' let
    tiles whose k and j ranges do not intersect drop the mask;
    rectangular calls always mask."""
    if (mass_k is None) != (mass_j is None):
        raise ValueError("vjp_rect_mxu needs both masses or neither")
    check_coincident(coincident)
    square = pos_k is pos_j
    rows = vjp_rect_mxu_rows(
        pos_k, g_k, pos_j, g_j, mass_k, mass_j, softening, tile,
        square_coincident=coincident if square else None)
    mk = pos_k.new_ones(pos_k.shape[0]) if mass_k is None else mass_k
    return _combine(rows, mk, g_k, pos_k)
