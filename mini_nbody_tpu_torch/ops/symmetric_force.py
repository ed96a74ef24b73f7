"""fp32 pair-once force: the ``"sym"`` backend, which ``"auto"`` runs.

Counterpart of ``mini_nbody_tpu/ops/symmetric_force.py`` (``:61-104``
_pair_block, ``:107-176`` the two kernels, ``:192-221`` _resolve_tiling /
_pack, ``:310-366`` body_force_symmetric, ``:581-658`` body_force_pair).
Each unordered pair's weight w is computed once and scattered to both
bodies: rows F_i += sum_j d w (m_j), reactions F_j -= sum_i d w (m_i), with
d = p_j - p_i and w = rsqrt(r2^3) (rsqrt(r2)^3 below softening 1e-12).

The traversal is the slot + fold geometry of ``ops/slot_pipe.py`` (K2), not
the TPU band: a self chunk runs its ``tri_slot_list`` (DIAG slots add row
sums only, FOLD slots pair two diagonal blocks in one tile), a chunk pair
a < b its ``cross_slot_list``. The JAX chunk loop stays (8 self-chunk + 28
chunk-pair launches at N = 2^20, chunk 131072), so no slot table spans all
N. ``symmetric_sums_`` ADDS one chunk's (or chunk pair's) sums into (c, 3)
accumulator views: CUDA tensors launch the hand-written kernel
``csrc/symmetric_force.cu`` (K3, which serves both Pallas kernels
``_tri_kernel`` and ``_cross_kernel``), CPU tensors take the plain version
``symmetric_sums_plain``, which walks the same slot list.

Positions are packed (Np, 3), or (Np, 4) with the mass as the 4th column;
tails are FAR-padded with zero mass, so pads add exactly zero. A coincident
pair has d = 0 and adds exactly zero, so this backend needs no coincident
mask. The kernel sums deterministically (``slot_pipe.run_slot_pieces``):
every output bit is the same on every run.

``body_force_symmetric_ensemble`` (``:369-389``, ``:453-520``) computes B
independent systems batched (B9b): each system is one chunk of its own,
c = round_up(N, tile) with its own FAR pads, and K3's tri mode runs the
same slot list over every system's blocks (``symmetric_sums_ensemble_``),
as many systems in a launch as fit in a piece of the slot list;
no chunk-pair pass runs. System i is bitwise
``body_force_symmetric(pos[i], mass[i], tile=t, chunk=c)``. JAX's
padded_auto_tile and its TPU calibration tables are not carried over: the
ensemble tile is ``ensemble_tiling``'s (ops/sym_mxu_force.py). The
tunnel-only segmented path is not ported.
"""

from __future__ import annotations

import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.ops import slot_pipe
from mini_nbody_tpu_torch.ops.slot_pipe import SLOT_CROSS, SLOT_DIAG, SLOT_FOLD
from mini_nbody_tpu_torch.ops.sym_mxu_force import (_resolve_tiling,
                                                    check_ensemble,
                                                    ensemble_tiling,
                                                    pack_ensemble)
from mini_nbody_tpu_torch.utils.config import (FAR, SOFTENING,
                                               fast_rsqrt_cube,
                                               plain_block_elems, round_up)

#: The port's default tile; the CUDA kernel is built for 64 and 128.
DEFAULT_TILE = 128
KERNEL_TILES = (64, 128)

#: The registry's counter of each kind of K3 call (utils/tracing.count),
#: counted at each launch on CUDA tensors (one per piece of the slot list
#: and group of systems, slot_pipe.run_slot_pieces): symmetric_sums_'s tri
#: and cross modes, and symmetric_sums_ensemble_ (B9b).
COUNTERS = {"tri": "launch.K3.tri", "cross": "launch.K3.cross",
            "ensemble": "launch.B9b"}


def _pack(pos, mass, n, np_):
    """Pad to np_ (FAR positions, zero masses) and pack the mass column:
    (np_, 3) unit-mass or (np_, 4)."""
    pos = pos.float()
    if np_ != n:
        pos = torch.cat([pos, pos.new_full((np_ - n, 3), FAR)])
    if mass is not None:
        m = mass.float()
        if np_ != n:
            m = torch.cat([m, m.new_zeros(np_ - n)])
        pos = torch.cat([pos, m[:, None]], dim=1)
    return pos.contiguous()


def _t_block(p, q, softening, fast):
    """The three (B, T, T) products d w, entry [r, c] for d = q[c] - p[r]."""
    d = [q[:, None, :, k] - p[:, :, None, k] for k in range(3)]
    return _times_w(d, softening, fast)


def _times_w(d, softening, fast):
    dx, dy, dz = d
    r2 = dx * dx + dy * dy + (dz * dz + softening)
    if fast:
        w = torch.rsqrt((r2 * r2) * r2)
    else:
        inv = torch.rsqrt(r2)
        w = (inv * inv) * inv
    return [dk * w for dk in d]


def _sums(t, p, q):
    """Row sums (B, T, 3) of t[r, c] m_q[c] and column sums of t[r, c]
    m_p[r]; the masses ride as the 4th column (unit masses without it)."""
    if p.shape[-1] == 4:
        mq, mp = q[:, None, :, 3], p[:, :, None, 3]
        rows = [(tk * mq).sum(-1) for tk in t]
        cols = [(tk * mp).sum(-2) for tk in t]
    else:
        rows = [tk.sum(-1) for tk in t]
        cols = [tk.sum(-2) for tk in t]
    return torch.stack(rows, -1), torch.stack(cols, -1)


def symmetric_sums_plain(acc_a, acc_b, pos_a, pos_b, slots, tile, softening):
    """Plain version of K3: for every slot add the row sums into acc_a
    (block bi) and subtract the reaction sums from acc_b (block bj), in
    batches of slots."""
    fast = fast_rsqrt_cube(softening)
    k = pos_a.shape[1]
    pa, pb = pos_a.view(-1, tile, k), pos_b.view(-1, tile, k)
    aa, ab = acc_a.view(-1, tile, 3), acc_b.view(-1, tile, 3)
    slots = slots.to(device=pos_a.device, dtype=torch.long)
    batch = max(1, plain_block_elems(pos_a.device) // (tile * tile))
    idx = torch.arange(tile, device=pos_a.device)
    lower = idx[None, :] < idx[:, None]  # [r, c]: c < r
    for kind in (SLOT_DIAG, SLOT_CROSS, SLOT_FOLD):
        sel = slots[slots[:, 0] == kind]
        for s in range(0, sel.shape[0], batch):
            bi, bj = sel[s:s + batch, 1], sel[s:s + batch, 2]
            p, q = pa[bi], pb[bj]
            if kind != SLOT_FOLD:
                rows, cols = _sums(_t_block(p, q, softening, fast), p, q)
                aa.index_add_(0, bi, rows)
                if kind == SLOT_CROSS:
                    ab.index_add_(0, bj, -cols)
                continue
            # FOLD: pairs of block bi below the diagonal, of bj above it.
            d = [torch.where(lower, p[:, None, :, c] - p[:, :, None, c],
                             q[:, None, :, c] - q[:, :, None, c])
                 for c in range(3)]
            t = _times_w(d, softening, fast)
            t_lo = [torch.where(lower, tk, torch.zeros_like(tk)) for tk in t]
            t_hi = [tk - lo for tk, lo in zip(t, t_lo)]
            rows, cols = _sums(t_lo, p, p)
            aa.index_add_(0, bi, rows - cols)
            rows, cols = _sums(t_hi, q, q)
            ab.index_add_(0, bj, rows - cols)


def _check(acc_a, acc_b, pos_a, pos_b, slots, tile):
    device = pos_a.device
    k = pos_a.shape[1]
    if k not in (3, 4):
        raise ValueError(f"packed positions have 3 or 4 columns, got {k}")
    for name, t, width in (("pos_a", pos_a, k), ("pos_b", pos_b, k),
                           ("acc_a", acc_a, 3), ("acc_b", acc_b, 3)):
        if t.shape[0] % tile != 0:
            raise ValueError(f"{name} rows {t.shape[0]} are not a multiple "
                             f"of tile {tile}")
        _build.check_tensor(name, t, (t.shape[0], width), torch.float32,
                            device)
    for a, b in ((acc_a, pos_a), (acc_b, pos_b)):
        if a.shape[0] != b.shape[0]:
            raise ValueError("each accumulator needs the rows of its bodies")
    _build.check_tensor("slots", slots, (slots.shape[0], 3), torch.int32,
                        device)


def _run_kernel(kind, acc_a, acc_b, pos_a, pos_b, slots, tile, softening,
                n_sys=1, sys_rows=0):
    """K3 on the card over n_sys systems of sys_rows rows (tri mode), a
    call of a ``kind`` of COUNTERS."""
    _build.refuse_grad("symmetric_sums_", pos_a, pos_b)
    if tile not in KERNEL_TILES:
        raise ValueError(f"the CUDA symmetric kernel takes tile in "
                         f"{KERNEL_TILES}, got {tile}")
    lib = _build.load_library()
    device = pos_a.device
    k = pos_a.shape[1]
    fast = int(fast_rsqrt_cube(softening))

    def launch(piece, n, g, g0, part):
        r0 = g0 * sys_rows
        return lib.symmetric_force_launch(
            piece.data_ptr(), n, g, sys_rows, pos_a[r0:].data_ptr(),
            pos_b[r0:].data_ptr(), part.data_ptr(), k, tile,
            float(softening), fast, _build.stream_ptr(device))

    with torch.cuda.device(device):
        slot_pipe.run_slot_pieces("symmetric_force_launch", slots,
                                  kind != "cross", tile, 3, acc_a, acc_b,
                                  launch, COUNTERS[kind], n_sys,
                                  sys_rows)


def symmetric_sums_(acc_a, acc_b, pos_a, pos_b, slots, tile, softening):
    """Add the pair-once sums of one self chunk (tri mode: acc_a and acc_b
    are the same memory, pos_a is pos_b, a tri slot table) or one pair of
    disjoint sets (cross mode: rows into acc_a, reactions into acc_b, a
    cross table)."""
    _check(acc_a, acc_b, pos_a, pos_b, slots, tile)
    if not _build.on_card(pos_a.device):
        symmetric_sums_plain(acc_a, acc_b, pos_a, pos_b, slots, tile,
                             softening)
        return
    cross = acc_a.data_ptr() != acc_b.data_ptr()
    _run_kernel("cross" if cross else "tri", acc_a, acc_b, pos_a, pos_b,
                slots, tile, softening)


def symmetric_sums_ensemble_(acc, pos, slots, tile, softening, n_sys):
    """B independent self chunks (B9b): systems of c = rows / n_sys rows
    stacked in pos (B c, 3|4) and acc (B c, 3), each summed over the same
    tri ``slots`` into its own rows. System i's sums are bitwise those of
    symmetric_sums_ on its rows alone, on the card (one kernel, the same
    pieces; a launch takes as many systems as slot_pipe.system_groups
    allows) and on the CPU (the same plain walk, system by system)."""
    rows = pos.shape[0]
    if n_sys < 1 or rows % n_sys != 0:
        raise ValueError(f"{rows} rows do not split into {n_sys} systems")
    c = rows // n_sys
    _check(acc, acc, pos, pos, slots, tile)
    if c % tile != 0:
        raise ValueError(f"a system has {c} rows, not a multiple of tile "
                         f"{tile}")
    if not _build.on_card(pos.device):
        for i in range(n_sys):
            sl = slice(i * c, (i + 1) * c)
            symmetric_sums_plain(acc[sl], acc[sl], pos[sl], pos[sl], slots,
                                 tile, softening)
        return
    _run_kernel("ensemble", acc, acc, pos, pos, slots, tile, softening,
                n_sys, c)


def body_force_symmetric(pos, mass=None, softening: float = SOFTENING,
                         tile: int | None = None, chunk: int = 131072):
    """All-pairs self-forces of pos (N,3), masses (N,) or None for unit
    masses, each pair computed once: (N,3) fp32. CUDA tensors run K3 (tile
    64 or 128), CPU tensors its plain version."""
    n = pos.shape[0]
    tile, c, nc, np_ = _resolve_tiling(
        n, DEFAULT_TILE if tile is None else tile, chunk,
        kernel=pos.device.type == "cuda")
    p = _pack(pos, mass, n, np_)
    acc = torch.zeros((np_, 3), dtype=torch.float32, device=p.device)
    nb = c // tile
    tri = slot_pipe.slot_table(nb, nb > 1, False, p.device)
    chunks = [slice(a * c, (a + 1) * c) for a in range(nc)]
    for sl in chunks:
        symmetric_sums_(acc[sl], acc[sl], p[sl], p[sl], tri, tile,
                        softening)
    if nc > 1:
        cross = slot_pipe.slot_table(nb, False, True, p.device)
        for a in range(nc):
            for b in range(a + 1, nc):
                sa, sb = chunks[a], chunks[b]
                symmetric_sums_(acc[sa], acc[sb], p[sa], p[sb], cross, tile,
                                softening)
    return acc[:n]


def body_force_pair(pos_a, pos_b, mass_a=None, mass_b=None,
                    softening: float = SOFTENING, tile: int | None = None):
    """Forces between two DISJOINT sets, each cross pair computed once:
    (F_on_a (Na,3), F_on_b (Nb,3)), F_on_b being the reactions. Masses
    both or neither: F_on_a weighted by m_b, F_on_b by m_a. Intra-set pairs
    are not computed."""
    if (mass_a is None) != (mass_b is None):
        raise ValueError("body_force_pair needs both masses or neither")
    na, nb = pos_a.shape[0], pos_b.shape[0]
    tile = DEFAULT_TILE if tile is None else tile
    if pos_a.device.type != "cuda":
        tile = min(tile, round_up(na, 8), round_up(nb, 8))
    pa = _pack(pos_a, mass_a, na, round_up(na, tile))
    pb = _pack(pos_b, mass_b, nb, round_up(nb, tile))
    acc_a = torch.zeros((pa.shape[0], 3), dtype=torch.float32,
                        device=pa.device)
    acc_b = torch.zeros((pb.shape[0], 3), dtype=torch.float32,
                        device=pb.device)
    slots = slot_pipe.slot_table(pa.shape[0] // tile, False, True, pa.device,
                                 nb_b=pb.shape[0] // tile)
    symmetric_sums_(acc_a, acc_b, pa, pb, slots, tile, softening)
    return acc_a[:na], acc_b[:nb]


def body_force_symmetric_ensemble(pos, mass=None,
                                  softening: float = SOFTENING,
                                  tile: int | None = None):
    """fp32 forces of B INDEPENDENT systems: pos (B, N, 3) [, mass (B, N)]
    -> (B, N, 3), no cross-system pairs. Each system is one chunk (c =
    round_up(N, tile), its own FAR pads) and K3's tri mode runs them with
    a system axis (B9b): one launch per piece of the slot list and group of
    systems, a group as many systems as keep it at or under
    slot_pipe.PIECE_SLOTS slots (all of them at small N, one at N = 65,536
    and tile 128); system i is bitwise ``body_force_symmetric(pos[i], mass[i],
    tile=t, chunk=c)`` with (t, c) = ensemble_tiling(N, tile, ...). CUDA
    tensors run the kernel, CPU tensors its plain version."""
    check_ensemble(pos, mass)
    b, n = pos.shape[0], pos.shape[1]
    t, c = ensemble_tiling(n, tile, kernel=_build.on_card(pos.device))
    p = pack_ensemble(pos, mass, c, _pack)
    acc = torch.zeros((b * c, 3), dtype=torch.float32, device=p.device)
    nb = c // t
    symmetric_sums_ensemble_(acc, p, slot_pipe.slot_table(nb, nb > 1, False,
                                                          p.device),
                             t, softening, b)
    return acc.view(b, c, 3)[:, :n]
