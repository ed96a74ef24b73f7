"""Symmetric x tensor-core force: each unordered pair's weight w computed
once in fp32, both the row sums and the reaction sums as bf16 products with
fp32 accumulation.

Counterpart of ``mini_nbody_tpu/ops/sym_mxu_force.py`` (the parts on the
slot path: ``:105-192`` any_coincident / COINCIDENT_AUTO_MIN_N /
resolve_auto (K2's gate; the other modules keep their own), ``:203-224``
_w_parts, ``:431-464`` _resolve_tiling / _pack,
``:507-559`` the chunk loop of _slot_accumulate, ``:588-651``
body_force_sym_mxu, ``:665-669`` _combine, ``:672-730``
body_force_pair_mxu). The accumulation identity is the
JAX one: with v = [m p | m],

    rows:      S_r = W @ v_j     F_i += S_r[:3] - p_i S_r[3]
    reactions: S_c = W^T @ v_i   F_j += S_c[:3] - p_j S_c[3]

so one (Np, 8) accumulator serves both sides, and v is split into the
compensated [vhi | vlo] operand (vhi = bf16(v) exact, vlo = v - vhi) so that
bf16 rounding of v costs ~16 mantissa bits instead of 8. The kernels are in
``ops/slot_pipe.py`` (K2); this module keeps the JAX chunk decomposition
(8 self-chunk launches + 28 chunk-pair launches at N = 2^20, chunk 131072).

Coincident bodies: self pairs are always masked (diagonal blocks, fold
diagonals). coincident='auto' runs an exact duplicate scan once per force
call (a host sync, replacing JAX's lax.cond) and picks the maskless kernel
when no two distinct bodies can have d2 == 0.

``body_force_pair_mxu`` (B4) computes the forces between two disjoint sets
of any lengths, each cross pair once: K2's cross mode over the na x nb block
rectangle (``slot_pipe.pair_slot_sums_``), rows into a and reactions into b.

``body_force_sym_mxu_ensemble`` (``:785-890``) computes B independent
systems batched (B9a, ``slot_pipe.tri_slot_sums_ensemble_``): each
system one chunk of c = round_up(N, tile) bodies with its own FAR pads, only
the tri pass, system i bitwise ``body_force_sym_mxu(pos[i], mass[i],
tile=t, chunk=c)``. ``ensemble_tiling`` picks the tile of both ensembles.

``traversal='band'`` runs the band traversal (``:226-428``, ``:562-580``,
``:653-662``, ``:880-890``) on B16 (``csrc/band_mxu.cu``): block pair
(i, (i + d) mod nb) at band step d of a self chunk, every (i, j) of a chunk
pair, row sums and reaction sums in separate (Np, 8) buffers that the
epilogue adds. ``band_tri_sums_``, ``band_cross_sums_`` and
``band_tri_sums_ensemble_`` launch B16 on CUDA tensors and take its plain
version ``_band_sums_plain`` on CPU tensors. The JAX segmented drivers are
tunnel-only and not ported (ROADMAP).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mini_nbody_tpu_torch.utils.config import (FAR, SOFTENING,
                                               check_coincident,
                                               fast_rsqrt_cube,
                                               plain_block_elems, round_up)
from mini_nbody_tpu_torch.utils.tracing import annotate, count

#: The port's default slot tile (the CUDA kernel takes 64 or 128; JAX's
#: 1024 is a VMEM-sized tile).
DEFAULT_TILE = 128

#: Below this many bodies 'auto' goes straight to K2's masked kernel
#: without the duplicate scan. Each module that reads a gate keeps its own
#: (mxu_force, vjp_kernel, vjp_mxu); JAX's single gate (sym_mxu_force.py:181)
#: was measured on a TPU. This one is K2's (and B4's, and the ensembles'
#: per system): chip_smoke.py's coincident_gate phase times 'masked' against
#: the scan plus the maskless kernel, and on an H100 the scan paid at no N
#: from 4096 to 262,144, the maskless K2 being no faster; so 'auto' is
#: 'masked' at every N. A caller that lowers the gate gets the scan and its
#: routing, with the same output bits.
COINCIDENT_AUTO_MIN_N = math.inf

#: The band traversal's gate (B16's own): below it 'auto' is 'masked'.
#: chip_smoke.py's coincident_gate phase on an H100 (median ms, masked
#: against the scan plus the maskless B16): the scan lost at every N from
#: 4096 to 131,072 (17.07 / 17.25 at 131,072) and paid at 262,144 (65.51 /
#: 63.86), the largest N it measures.
BAND_COINCIDENT_AUTO_MIN_N = 262144

#: The registry's counter of each B16 mode (utils/tracing.count), counted
#: at each launch on CUDA tensors: tri, cross and tri over a system axis
#: ("ensemble"). A call launches once per piece of its row blocks and group
#: of systems (band_pieces), and after each launch that stores column
#: partials, csrc/slot_reduce.cu once (launch.band_reduce).
BAND_COUNTERS = {"tri": "launch.B16.tri", "cross": "launch.B16.cross",
                 "ensemble": "launch.B16.ensemble"}

#: (tile, 8) fp32 column-partial tiles of one B16 launch: one per row block
#: and band step of its piece and systems (4 GiB at tile 128). A call's row
#: blocks split into the fewest equal ranges that keep one system's piece at
#: or under this; at tile 128 and chunk 131,072 a tri call and a cross call
#: are one piece each, so one launch of 1024 CTAs.
BAND_PIECE_TILES = 1 << 20


def _w_block(pi, pj, softening, fast, mask=True):
    """Pair weights for batched blocks: pi (B,T,3) rows, pj (B,T,3) columns
    -> w (B,T,T), entry [r, c] for d = pj[c] - pi[r]; d2 == 0 masked iff
    ``mask``. A real body against a FAR pad gets w = 0 exactly; FAR-vs-FAR
    pad pairs left unmasked get softening^-1.5 and land only in pad rows."""
    dx = pj[:, None, :, 0] - pi[:, :, None, 0]
    dy = pj[:, None, :, 1] - pi[:, :, None, 1]
    dz = pj[:, None, :, 2] - pi[:, :, None, 2]
    return _w_from_d(dx, dy, dz, softening, fast, mask)


def _w_from_d(dx, dy, dz, softening, fast, mask):
    d2 = dx * dx + dy * dy + dz * dz
    r2 = d2 + softening
    if fast:
        w = torch.rsqrt((r2 * r2) * r2)
    else:
        inv = torch.rsqrt(r2)
        w = (inv * inv) * inv
    if mask:
        w = torch.where(d2 == 0.0, torch.zeros_like(w), w)
    return w


def _w_parts(w, split_w):
    """(whi, wlo) on the bf16 grid for the compensated w split, or (w,)."""
    if not split_w:
        return (w,)
    whi = w.to(torch.bfloat16).float()
    return (whi, w - whi)


def any_coincident(pos) -> bool:
    """True iff pos (N,3) (or rows with more columns, all compared) could
    hold a d2 == 0 pair between DISTINCT bodies
    (JAX sym_mxu_force.py:105-142): exact duplicate rows (after -0.0 ->
    +0.0), any coordinate with 0 < |c| < 2^-48, or any |c| >= FAR. Returns
    a Python bool, so it syncs with the device. Every caller's scan is one
    nbody.coincident_scan span and one count of coincident.scan."""
    count("coincident.scan")
    with annotate("nbody.coincident_scan"):
        p = pos.float() + 0.0
        dup = torch.unique(p, dim=0).shape[0] < p.shape[0]
        a = p.abs()
        flags = ((a > 0.0) & (a < 2.0 ** -48)).any() | (a >= FAR).any()
        return dup or bool(flags)


def any_coincident_ensemble(pos) -> bool:
    """any_coincident within each system of pos (B, N, 3), in one scan of
    the rows tagged with their system's index: two systems may hold bodies
    at the same point, since their pairs are never computed. Returns a
    Python bool, so it syncs with the device."""
    b, n = pos.shape[0], pos.shape[1]
    sys_id = torch.arange(b, dtype=torch.float32, device=pos.device)
    return any_coincident(torch.cat([sys_id.repeat_interleave(n)[:, None],
                                     pos.reshape(b * n, 3).float()], dim=1))


def resolve_auto(coincident: str, n: int, min_n: float | None = None) -> str:
    """Below the gate min_n (COINCIDENT_AUTO_MIN_N, K2's, when None; each
    module passes its own) 'auto' is 'masked' (same outputs, no duplicate
    scan)."""
    gate = COINCIDENT_AUTO_MIN_N if min_n is None else min_n
    if coincident == "auto" and n < gate:
        return "masked"
    return coincident


def _resolve_tiling(n, tile, chunk, kernel):
    """(tile, c, nc, Np). The plain path shrinks the tile to the problem
    like JAX's interpret mode; the kernel keeps its tile (64 or 128) and
    pads, with FAR tails inert."""
    if not kernel:
        tile = min(tile, round_up(n, 8))
    nc = max(1, -(-n // chunk))
    c = round_up(-(-n // nc), tile)
    return tile, c, nc, nc * c


def _pack(pos, mass, n, np_):
    """Pad (FAR positions, zero masses) and build v = [m p | m] (unit masses
    when mass is None) as the (Np, 8) compensated [vhi | vlo] operand."""
    pos = pos.float()
    if np_ != n:
        pos = torch.cat([pos, pos.new_full((np_ - n, 3), FAR)])
    if mass is None:
        v = torch.cat([pos, pos.new_ones((np_, 1))], dim=1)
    else:
        m = mass.float()
        if np_ != n:
            m = torch.cat([m, m.new_zeros(np_ - n)])
        v = torch.cat([pos * m[:, None], m[:, None]], dim=1)
    vhi = v.to(torch.bfloat16).float()
    return pos.contiguous(), torch.cat([vhi, v - vhi], dim=1).contiguous()


def ensemble_tiling(n, tile, kernel):
    """(tile, c) of the ensembles: one chunk per system, _resolve_tiling
    with chunk = n. On the card the default tile is whichever of the
    kernels' tiles (64, 128) pads less pair work, round_up(n, t)^2, ties to
    128 (JAX's padded_auto_tile and its TPU calibration are not carried
    over); on the CPU it is DEFAULT_TILE, shrunk to the problem as the plain
    path does."""
    if tile is None:
        tile = DEFAULT_TILE
        if kernel:
            tile = min((128, 64), key=lambda t: round_up(n, t) ** 2)
    t, c, _, _ = _resolve_tiling(n, tile, n, kernel)
    return t, c


def check_ensemble(pos, mass):
    """Raise unless pos is (B, N, 3) and mass None or (B, N)."""
    if pos.ndim != 3 or pos.shape[-1] != 3:
        raise ValueError(f"ensemble pos must be (B, N, 3), got "
                         f"{tuple(pos.shape)}")
    if mass is not None and tuple(mass.shape) != tuple(pos.shape[:2]):
        raise ValueError(f"ensemble mass must be (B, N) = "
                         f"{tuple(pos.shape[:2])}, got {tuple(mass.shape)}")


def pack_ensemble(pos, mass, c, pack):
    """Pad each system of pos (B, N, 3) [mass (B, N)] to c bodies (FAR
    positions, zero masses) and pack the stack of B c bodies with
    ``pack(pos (B c, 3), mass (B c,) or None, B c, B c)``, the standalone
    packing of each system."""
    b, n = pos.shape[0], pos.shape[1]
    pos = pos.float()
    if c != n:
        pos = torch.cat([pos, pos.new_full((b, c - n, 3), FAR)], dim=1)
    m = None
    if mass is not None:
        m = mass.float()
        if c != n:
            m = torch.cat([m, m.new_zeros((b, c - n))], dim=1)
        m = m.reshape(b * c)
    return pack(pos.reshape(b * c, 3), m, b * c, b * c)


def _slot_accumulate(pos, v, softening, tile, c, nc, split_w, mask_offdiag,
                     fold=True):
    """The (Np, 8) accumulator: one self-chunk (tri) pass per chunk, then
    one chunk-pair (cross) pass per a < b, all into views of one buffer."""
    from mini_nbody_tpu_torch.ops import slot_pipe

    acc = torch.zeros((nc * c, 8), dtype=torch.float32, device=pos.device)
    nb = c // tile
    tri = slot_pipe.slot_table(nb, fold and nb > 1, False, pos.device)
    chunks = [slice(a * c, (a + 1) * c) for a in range(nc)]
    for sl in chunks:
        slot_pipe.tri_slot_sums_(acc[sl], pos[sl], v[sl], tri, tile,
                                 softening, split_w, mask_offdiag)
    if nc > 1:
        cross = slot_pipe.slot_table(nb, False, True, pos.device)
        for a in range(nc):
            for b in range(a + 1, nc):
                sa, sb = chunks[a], chunks[b]
                slot_pipe.cross_slot_sums_(
                    acc[sa], acc[sb], pos[sa], pos[sb], v[sa], v[sb], cross,
                    tile, softening, split_w, mask_offdiag)
    return acc


def _combine(pos, s):
    """Fold the [hi | lo] columns and form F = s[:, :3] - p * s[:, 3]."""
    s = s[:, 0:4] + s[:, 4:8]
    return s[:, 0:3] - pos * s[:, 3:4]


# ---------------------------------------------------- band traversal (B16)

def band_steps(nb: int, cross: bool) -> int:
    """Band steps per row block: d = 0 .. nb // 2 of a self chunk (block
    pair (i, (i + d) mod nb)), j = 0 .. nb - 1 of a chunk pair."""
    return nb if cross else nb // 2 + 1


def band_pieces(nb: int, cross: bool):
    """One system's row blocks as (i0, i1) ranges, ascending: the fewest
    equal contiguous ranges of at most BAND_PIECE_TILES tiles each."""
    per = max(1, BAND_PIECE_TILES // band_steps(nb, cross))
    size = -(-nb // -(-nb // per))
    return [(i0, min(nb, i0 + size)) for i0 in range(0, nb, size)]


def band_launches(nb: int, cross: bool, n_sys: int = 1):
    """How a B16 call over n_sys systems of nb row blocks launches:
    (band_pieces, systems per launch, scratch tiles of one system's
    largest piece). A launch takes as many systems as keep its scratch at
    or under BAND_PIECE_TILES tiles, at least one, at most the kernels'
    gridDim.y."""
    from mini_nbody_tpu_torch.ops.slot_pipe import MAX_SYSTEMS

    pieces = band_pieces(nb, cross)
    longest = max(i1 - i0 for i0, i1 in pieces) * band_steps(nb, cross)
    group = min(n_sys, max(1, BAND_PIECE_TILES // longest), MAX_SYSTEMS)
    return pieces, group, longest


@functools.lru_cache(maxsize=64)
def _band_plan_np(nb: int, cross: bool, i0: int, i1: int):
    """The column reduction of row blocks [i0, i1) in slot_reduce's form:
    (targets, offsets, entries), target 2 j for column block j (one
    accumulator), entries[offsets[t]:offsets[t + 1]] its partial tiles
    (i - i0) * steps + d in increasing i, the TPU grid's order. Tiles of
    a self chunk's diagonal (d == 0) and of the inactive half of an even
    nb's wrap band (d == nb / 2, i >= nb / 2) hold no partial."""
    steps = band_steps(nb, cross)
    i, d = (a.ravel() for a in np.meshgrid(
        np.arange(i0, i1), np.arange(0 if cross else 1, steps),
        indexing="ij"))
    if cross:
        j = d
    else:
        keep = (2 * d != nb) | (2 * i < nb)
        i, d = i[keep], d[keep]
        j = (i + d) % nb
    order = np.lexsort((i, j))
    j, entries = j[order], ((i - i0) * steps + d)[order]
    targets, starts = np.unique(j, return_index=True)
    return (2 * targets, np.append(starts, j.size), entries)


@functools.lru_cache(maxsize=64)
def _band_plan(nb: int, cross: bool, i0: int, i1: int, device: str):
    """_band_plan_np on ``device``, with slot_reduce's launch order as a
    4th array: (targets, offsets, entries, order)."""
    from mini_nbody_tpu_torch.ops.slot_pipe import launch_order

    arrays = _band_plan_np(nb, cross, i0, i1)
    return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                 for a in (*arrays, launch_order(arrays[1])))


def _band_sums_plain(rows, cols, pos_a, pos_b, v_a, v_b, tile, softening,
                     split_w, mask_offdiag, cross, mma_dtype=torch.float32):
    """Plain version of B16 on one system: the same walk (for each band
    step d, every active row block i at once), row sums added in d order
    per block, each off-diagonal tile's column partial stored, then each
    column block's partials summed in increasing i (_band_plan_np) and
    added to cols. mma_dtype=torch.float32 multiplies in fp32 (JAX's CPU
    interpret run); torch.bfloat16 rounds w and v as the tensor cores
    do."""
    from mini_nbody_tpu_torch.ops.slot_pipe import _mm

    fast = fast_rsqrt_cube(softening)
    dev = pos_a.device
    nb = pos_a.shape[0] // tile
    steps = band_steps(nb, cross)
    pa, pb = pos_a.view(nb, tile, 3), pos_b.view(nb, tile, 3)
    va, vb = v_a.view(nb, tile, 8), v_b.view(nb, tile, 8)
    row_sum = torch.zeros((nb, tile, 8), dtype=torch.float32, device=dev)
    # The partials, and one zero tile that pads the reduction's table.
    part = torch.zeros((nb * steps + 1, tile, 8), dtype=torch.float32,
                       device=dev)
    batch = max(1, plain_block_elems(dev) // (tile * tile))
    blocks = torch.arange(nb, device=dev)
    for d in range(steps):
        diag = not cross and d == 0
        i = blocks if cross or 2 * d != nb else blocks[:nb // 2]
        j = torch.full_like(i, d) if cross else (i + d) % nb
        for s in range(0, i.shape[0], batch):
            bi, bj = i[s:s + batch], j[s:s + batch]
            w = _w_parts(_w_block(pa[bi], pb[bj], softening, fast,
                                  mask=diag or mask_offdiag), split_w)
            row_sum[bi] = row_sum[bi] + _mm(w, vb[bj], False, mma_dtype)
            if not diag:
                part[bi * steps + d] = _mm(w, va[bi], True, mma_dtype)
    rows.view(nb, tile, 8).add_(row_sum)
    targets, offsets, entries = _band_plan_np(nb, cross, 0, nb)
    counts = np.diff(offsets)
    if counts.size == 0:
        return
    table = np.full((counts.size, counts.max()), nb * steps)
    group = np.repeat(np.arange(counts.size), counts)
    table[group, np.arange(entries.size) - offsets[group]] = entries
    table = torch.from_numpy(table).to(dev)
    col_sum = torch.zeros((counts.size, tile, 8), dtype=torch.float32,
                          device=dev)
    for k in range(table.shape[1]):
        col_sum = col_sum + part[table[:, k]]
    cv = cols.view(nb, tile, 8)
    tj = torch.from_numpy(targets // 2).to(dev)
    cv[tj] = cv[tj] + col_sum


def _band_kernel(kind, rows, cols, pos_a, pos_b, v_a, v_b, tile, softening,
                 split_w, mask_offdiag, n_sys, c):
    """B16 on the card, a call of a ``kind`` of BAND_COUNTERS: for each piece
    of row blocks and group of systems one launch, then one slot_reduce
    launch that adds the piece's column partials to cols in increasing i."""
    from mini_nbody_tpu_torch import _build
    from mini_nbody_tpu_torch.ops import slot_pipe

    _build.refuse_grad("band_mxu", pos_a, pos_b, v_a, v_b)
    if tile not in slot_pipe.KERNEL_TILES:
        raise ValueError(f"the CUDA band kernel takes tile in "
                         f"{slot_pipe.KERNEL_TILES}, got {tile}")
    lib = _build.load_library()
    device = pos_a.device
    cross = kind == "cross"
    nb = c // tile
    steps = band_steps(nb, cross)
    pieces, group, longest = band_launches(nb, cross, n_sys)
    part = torch.empty(group * longest * tile * 8, dtype=torch.float32,
                       device=device)
    fast = int(fast_rsqrt_cube(softening))
    with torch.cuda.device(device):
        stream = _build.stream_ptr(device)
        for i0, i1 in pieces:
            targets, offsets, entries, order = _band_plan(nb, cross, i0,
                                                          i1, str(device))
            for g0 in range(0, n_sys, group):
                g, r0 = min(group, n_sys - g0), g0 * c
                _build.check(lib, lib.band_mxu_launch(
                    pos_a[r0:].data_ptr(), pos_b[r0:].data_ptr(),
                    v_a[r0:].data_ptr(), v_b[r0:].data_ptr(),
                    rows[r0:].data_ptr(), part.data_ptr(), nb, i0, i1 - i0,
                    int(cross), g, c, tile, float(softening), fast,
                    int(split_w), int(mask_offdiag), stream),
                    "band_mxu_launch")
                count(BAND_COUNTERS[kind])
                if targets.shape[0] == 0:
                    continue
                _build.check(lib, lib.slot_reduce_launch(
                    part.data_ptr(), tile * 8, targets.shape[0],
                    targets.data_ptr(), offsets.data_ptr(),
                    entries.data_ptr(), order.data_ptr(),
                    cols[r0:].data_ptr(),
                    cols[r0:].data_ptr(), g, c * 8, (i1 - i0) * steps,
                    stream), "slot_reduce_launch")
                count("launch.band_reduce")


def _band_launch(kind, rows, cols, pos_a, pos_b, v_a, v_b, tile, softening,
                 split_w, mask_offdiag, n_sys=1):
    """Check the operands of a B16 call over n_sys systems of c rows each
    (both sides c rows), then launch the kernel (CUDA tensors) or walk the
    plain version system by system (CPU tensors)."""
    from mini_nbody_tpu_torch import _build

    total = pos_a.shape[0]
    if n_sys < 1 or total % n_sys != 0:
        raise ValueError(f"{total} rows do not split into {n_sys} systems")
    c = total // n_sys
    if c % tile != 0:
        raise ValueError(f"a chunk has {c} rows, not a multiple of tile "
                         f"{tile}")
    device = pos_a.device
    for name, t, width in (("pos_a", pos_a, 3), ("pos_b", pos_b, 3),
                           ("v_a", v_a, 8), ("v_b", v_b, 8),
                           ("rows", rows, 8), ("cols", cols, 8)):
        _build.check_tensor(name, t, (total, width), torch.float32, device)
    if not _build.on_card(device):
        for s in range(n_sys):
            sl = slice(s * c, (s + 1) * c)
            _band_sums_plain(rows[sl], cols[sl], pos_a[sl], pos_b[sl],
                             v_a[sl], v_b[sl], tile, softening, split_w,
                             mask_offdiag, kind == "cross")
        return
    _band_kernel(kind, rows, cols, pos_a, pos_b, v_a, v_b, tile, softening,
                 split_w, mask_offdiag, n_sys, c)


def band_tri_sums_(rows, cols, pos, v, tile, softening, split_w=False,
                   mask_offdiag=True):
    """Self chunk pos (c, 3), v (c, 8) on the band: ADD its row sums into
    rows (c, 8) and its reaction sums into cols (c, 8)."""
    _band_launch("tri", rows, cols, pos, pos, v, v, tile, softening,
                 split_w, mask_offdiag)


def band_cross_sums_(rows_a, cols_b, pos_a, pos_b, v_a, v_b, tile,
                     softening, split_w=False, mask=True):
    """Chunk pair a != b (c rows each) on the (nb, nb) grid: ADD the row
    sums of a into rows_a and the reaction sums of b into cols_b."""
    _band_launch("cross", rows_a, cols_b, pos_a, pos_b, v_a, v_b, tile,
                 softening, split_w, mask)


def band_tri_sums_ensemble_(rows, cols, pos, v, tile, softening, n_sys,
                            split_w=False, mask_offdiag=True):
    """n_sys independent self chunks stacked in pos (B c, 3), v (B c, 8),
    rows and cols (B c, 8), each on its own band: system i's sums are
    bitwise band_tri_sums_ on its rows alone (the same kernel and pieces on
    the card, the same plain walk on the CPU)."""
    _band_launch("ensemble", rows, cols, pos, pos, v, v, tile, softening,
                 split_w, mask_offdiag, n_sys)


def _band_accumulate(pos, v, softening, tile, c, nc, split_w, mask_offdiag):
    """Raw (rows (Np, 8), cols (Np, 8)) band sums: one tri call per chunk,
    then one cross call per chunk pair a < b in row-major order (JAX
    ``_accumulate``, hostseg.cross_pair_offsets)."""
    rows = torch.zeros((nc * c, 8), dtype=torch.float32, device=pos.device)
    cols = torch.zeros_like(rows)
    chunks = [slice(a * c, (a + 1) * c) for a in range(nc)]
    for sl in chunks:
        band_tri_sums_(rows[sl], cols[sl], pos[sl], v[sl], tile, softening,
                       split_w, mask_offdiag)
    for a in range(nc):
        for b in range(a + 1, nc):
            sa, sb = chunks[a], chunks[b]
            band_cross_sums_(rows[sa], cols[sb], pos[sa], pos[sb], v[sa],
                             v[sb], tile, softening, split_w, mask_offdiag)
    return rows, cols


def _check_traversal(traversal: str) -> bool:
    """Raise on an unknown traversal; whether it is the band ('auto' is
    the slots, as JAX's resolve_traversal has it)."""
    if traversal not in ("auto", "slots", "band"):
        raise ValueError(f"unknown traversal {traversal!r}")
    return traversal == "band"


def body_force_sym_mxu(pos, mass=None, softening: float = SOFTENING,
                       tile: int | None = None, chunk: int = 131072,
                       split_w: bool = False, coincident: str = "auto",
                       traversal: str = "auto"):
    """All-pairs self-forces of pos (N,3) [masses (N,)]: (N,3) fp32.

    bf16-accumulate error class with the compensated operand split;
    split_w adds a second product pass on w's bf16 remainder. coincident:
    'auto' (duplicate scan, then the masked or maskless kernel), 'masked'
    (d2 == 0 mask in every block) or 'fast' (maskless; the caller
    guarantees distinct positions). traversal: 'auto' or 'slots' (the slot
    list, K2) or 'band' (the band, B16, row and reaction sums added in the
    epilogue), each with its own coincident gate. CUDA tensors run the
    kernel, CPU tensors its plain version."""
    check_coincident(coincident)
    band = _check_traversal(traversal)
    n = pos.shape[0]
    coincident = resolve_auto(coincident, n,
                              BAND_COINCIDENT_AUTO_MIN_N if band else None)
    tile, c, nc, np_ = _resolve_tiling(
        n, DEFAULT_TILE if tile is None else tile, chunk,
        kernel=pos.device.type == "cuda")
    if coincident == "auto":
        mask_offdiag = any_coincident(pos)
    else:
        mask_offdiag = coincident == "masked"
    pos_p, v = _pack(pos, mass, n, np_)
    if band:
        rows, cols = _band_accumulate(pos_p, v, softening, tile, c, nc,
                                      split_w, mask_offdiag)
        return _combine(pos_p, rows + cols)[:n]
    acc = _slot_accumulate(pos_p, v, softening, tile, c, nc, split_w,
                           mask_offdiag)
    return _combine(pos_p, acc)[:n]


def body_force_pair_mxu(pos_a, pos_b, mass_a=None, mass_b=None,
                        softening: float = SOFTENING, tile: int = DEFAULT_TILE,
                        split_w: bool = False, coincident: str = "masked"):
    """Forces between two disjoint body sets, each cross pair's w computed
    once: (F_on_a (Na,3), F_on_b (Nb,3)), F_on_b the reactions. Masses both
    or neither. coincident: "masked" (default), "fast" (the caller
    guarantees no cross-set duplicates) or "auto" (one duplicate scan of the
    concatenated sets; a within-set duplicate also routes to masked). CUDA
    tensors run K2's cross mode over the rectangle (tile 64 or 128, the sets
    padded to it), CPU tensors its plain version at JAX's interpret tile
    min(tile, round_up(na, 8), round_up(nb, 8))."""
    from mini_nbody_tpu_torch import _build
    from mini_nbody_tpu_torch.ops import slot_pipe

    if (mass_a is None) != (mass_b is None):
        raise ValueError("body_force_pair_mxu needs both masses or neither")
    check_coincident(coincident)
    na, nb = pos_a.shape[0], pos_b.shape[0]
    coincident = resolve_auto(coincident, na + nb)
    t = tile
    if not _build.on_card(pos_a.device):
        t = min(tile, round_up(na, 8), round_up(nb, 8))
    na_p, nb_p = round_up(na, t), round_up(nb, t)
    if coincident == "auto":
        mask = any_coincident(torch.cat([pos_a, pos_b]))
    else:
        mask = coincident == "masked"
    pa, va = _pack(pos_a, mass_a, na, na_p)
    pb, vb = _pack(pos_b, mass_b, nb, nb_p)
    acc_a = torch.zeros((na_p, 8), dtype=torch.float32, device=pa.device)
    acc_b = torch.zeros((nb_p, 8), dtype=torch.float32, device=pa.device)
    slots = slot_pipe.slot_table(na_p // t, False, True, pa.device,
                                 nb_b=nb_p // t)
    slot_pipe.pair_slot_sums_(acc_a, acc_b, pa, pb, va, vb, slots, t,
                              softening, split_w, mask)
    return _combine(pa, acc_a)[:na], _combine(pb, acc_b)[:nb]


def body_force_sym_mxu_ensemble(pos, mass=None,
                                softening: float = SOFTENING,
                                tile: int | None = None,
                                split_w: bool = False,
                                coincident: str = "auto",
                                traversal: str = "auto"):
    """Forces of B INDEPENDENT systems: pos (B, N, 3) [, mass (B, N)] ->
    (B, N, 3), no cross-system pairs. Each system is one chunk (c =
    round_up(N, tile), its own FAR pads) and K2's tri mode runs the same
    slot list over every system (B9a), as many systems in a launch as
    slot_pipe.system_groups allows; traversal='band' runs B16's tri mode
    over a system axis instead. System i is bitwise
    ``body_force_sym_mxu(pos[i], mass[i], tile=t, chunk=c,
    traversal=traversal)`` with (t, c) = ensemble_tiling(N, tile, ...).

    coincident='auto' scans for duplicates WITHIN each system only (the
    gate is the per-system N): two systems may hold bodies at the same
    positions, since their pairs are never computed. CUDA tensors run the
    kernel, CPU tensors its plain version."""
    from mini_nbody_tpu_torch import _build
    from mini_nbody_tpu_torch.ops import slot_pipe

    check_coincident(coincident)
    check_ensemble(pos, mass)
    band = _check_traversal(traversal)
    b, n = pos.shape[0], pos.shape[1]
    t, c = ensemble_tiling(n, tile, kernel=_build.on_card(pos.device))
    coincident = resolve_auto(coincident, n,
                              BAND_COINCIDENT_AUTO_MIN_N if band else None)
    if coincident == "auto":
        mask_offdiag = any_coincident_ensemble(pos)
    else:
        mask_offdiag = coincident == "masked"
    pos_p, v = pack_ensemble(pos, mass, c, _pack)
    acc = torch.zeros((b * c, 8), dtype=torch.float32, device=pos_p.device)
    if band:
        cols = torch.zeros_like(acc)
        band_tri_sums_ensemble_(acc, cols, pos_p, v, t, softening, b,
                                split_w, mask_offdiag)
        return _combine(pos_p, acc + cols).view(b, c, 3)[:, :n]
    nb = c // t
    slot_pipe.tri_slot_sums_ensemble_(
        acc, pos_p, v, slot_pipe.slot_table(nb, nb > 1, False, pos_p.device),
        t, softening, b, split_w, mask_offdiag)
    return _combine(pos_p, acc).view(b, c, 3)[:, :n]
