"""Symmetric x tensor-core force: each unordered pair's weight w computed
once in fp32, both the row sums and the reaction sums as bf16 products with
fp32 accumulation.

Counterpart of ``mini_nbody_tpu/ops/sym_mxu_force.py`` (the parts on the
slot path: ``:105-192`` any_coincident / COINCIDENT_AUTO_MIN_N /
resolve_auto, ``:203-224`` _w_parts, ``:431-464`` _resolve_tiling / _pack,
``:507-559`` the chunk loop of _slot_accumulate, ``:588-651``
body_force_sym_mxu, ``:665-669`` _combine). The accumulation identity is the
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
when no two distinct bodies can have d2 == 0. The band traversal, the
ensembles, body_force_pair_mxu and the segmented drivers are not ported yet
(ROADMAP).
"""

from __future__ import annotations

import torch

from mini_nbody_tpu_torch.utils.config import (FAR, SOFTENING,
                                               check_coincident, round_up)

#: The port's default slot tile (the CUDA kernel takes 64 or 128; JAX's
#: 1024 is a VMEM-sized tile).
DEFAULT_TILE = 128

#: Below this many bodies 'auto' goes straight to the masked kernel without
#: the duplicate scan (the JAX gate, sym_mxu_force.py:181, measured on a
#: TPU; the H100 crossover is not measured yet).
COINCIDENT_AUTO_MIN_N = 8192


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
    """True iff pos (N,3) could hold a d2 == 0 pair between DISTINCT bodies
    (JAX sym_mxu_force.py:105-142): exact duplicate rows (after -0.0 ->
    +0.0), any coordinate with 0 < |c| < 2^-48, or any |c| >= FAR. Returns
    a Python bool, so it syncs with the device."""
    p = pos.float() + 0.0
    dup = torch.unique(p, dim=0).shape[0] < p.shape[0]
    a = p.abs()
    flags = ((a > 0.0) & (a < 2.0 ** -48)).any() | (a >= FAR).any()
    return dup or bool(flags)


def resolve_auto(coincident: str, n: int) -> str:
    """Below COINCIDENT_AUTO_MIN_N 'auto' is 'masked' (same outputs, no
    duplicate scan)."""
    if coincident == "auto" and n < COINCIDENT_AUTO_MIN_N:
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
