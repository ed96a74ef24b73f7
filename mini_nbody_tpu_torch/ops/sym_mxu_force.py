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
The band traversal and the segmented drivers are not ported yet (ROADMAP).
"""

from __future__ import annotations

import math

import torch

from mini_nbody_tpu_torch.utils.config import (FAR, SOFTENING,
                                               check_coincident, round_up)

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
    a Python bool, so it syncs with the device."""
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


def body_force_sym_mxu(pos, mass=None, softening: float = SOFTENING,
                       tile: int | None = None, chunk: int = 131072,
                       split_w: bool = False, coincident: str = "auto",
                       traversal: str = "auto"):
    """All-pairs self-forces of pos (N,3) [masses (N,)]: (N,3) fp32.

    bf16-accumulate error class with the compensated operand split;
    split_w adds a second product pass on w's bf16 remainder. coincident:
    'auto' (duplicate scan, then the masked or maskless kernel), 'masked'
    (d2 == 0 mask in every block) or 'fast' (maskless; the caller
    guarantees distinct positions). CUDA tensors run K2, CPU tensors its
    plain version."""
    check_coincident(coincident)
    if traversal == "band":
        raise NotImplementedError(
            "traversal='band' is not ported yet (ROADMAP B16)")
    if traversal not in ("auto", "slots"):
        raise ValueError(f"unknown traversal {traversal!r}")
    n = pos.shape[0]
    coincident = resolve_auto(coincident, n)
    tile, c, nc, np_ = _resolve_tiling(
        n, DEFAULT_TILE if tile is None else tile, chunk,
        kernel=pos.device.type == "cuda")
    if coincident == "auto":
        mask_offdiag = any_coincident(pos)
    else:
        mask_offdiag = coincident == "masked"
    pos_p, v = _pack(pos, mass, n, np_)
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
    slot_pipe.system_groups allows; system i is bitwise
    ``body_force_sym_mxu(pos[i], mass[i], tile=t, chunk=c)`` with (t, c) =
    ensemble_tiling(N, tile, ...).

    coincident='auto' scans for duplicates WITHIN each system only (the
    gate is the per-system N): two systems may hold bodies at the same
    positions, since their pairs are never computed. CUDA tensors run the
    kernel, CPU tensors its plain version."""
    from mini_nbody_tpu_torch import _build
    from mini_nbody_tpu_torch.ops import slot_pipe

    check_coincident(coincident)
    check_ensemble(pos, mass)
    if traversal == "band":
        raise NotImplementedError(
            "traversal='band' is not ported yet (ROADMAP B16)")
    if traversal not in ("auto", "slots"):
        raise ValueError(f"unknown traversal {traversal!r}")
    b, n = pos.shape[0], pos.shape[1]
    t, c = ensemble_tiling(n, tile, kernel=_build.on_card(pos.device))
    coincident = resolve_auto(coincident, n)
    if coincident == "auto":
        mask_offdiag = any_coincident_ensemble(pos)
    else:
        mask_offdiag = coincident == "masked"
    pos_p, v = pack_ensemble(pos, mass, c, _pack)
    acc = torch.zeros((b * c, 8), dtype=torch.float32, device=pos_p.device)
    nb = c // t
    slot_pipe.tri_slot_sums_ensemble_(
        acc, pos_p, v, slot_pipe.slot_table(nb, nb > 1, False, pos_p.device),
        t, softening, b, split_w, mask_offdiag)
    return _combine(pos_p, acc).view(b, c, 3)[:, :n]
