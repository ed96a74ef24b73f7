"""Ordered tensor-core hybrid force (the ``mxu`` backend): each ordered
pair's weight in fp32, the weighted sums as one product per tile.

Counterpart of ``mini_nbody_tpu/ops/mxu_force.py`` (``:69-95`` _pair_sums,
``:98-148`` _hybrid_kernel, ``:151-292`` body_force_mxu). The accumulation
identity is JAX's:

    F_i = sum_j w_ij (p_j - p_i) = S[:, :3] - p_i S[:, 3],  S = W @ [p_j | 1]

with d = p_j - p_i, inv = rsqrt(|d|^2 + eps), w = (inv inv) inv (not the
rsqrt(r2^3) form of sym_mxu), zeroed where the pre-softening |d|^2 == 0 in
masked tiles, times m_j in fp32. pair_dtype picks the precision class:

- ``"bfloat16"``: W is rounded to bf16 and multiplied into the (Nj, 8)
  compensated operand [vhi | vlo] of v = [p | 1] (vhi = bf16(v), vlo =
  v - vhi) with fp32 accumulation; the epilogue folds hi + lo. The masses
  sit in w, not in v: this is not sym_mxu's ``_pack``.
- ``"float32"``: the fp32-exact class (JAX's Precision.HIGHEST). The port
  sums the identity's right-hand side, w d, in fp32 (B6's fp32 FMAs): in
  sequential fp32 sums the identity form loses ~ulp(w |p|) per add, and the
  epilogue's cancellation lifts that above the fp32 class near close pairs
  (csrc/mxu_force.cu). The raw sums are then the forces.

Coincident bodies: square calls (pos_j is pos_i, by identity) resolve
coincident as JAX does (``:207-216``, ``:285-290``): "masked" masks every
tile, "fast" only the tile pairs whose i and j ranges meet (where every self
pair lies), and "auto" runs the duplicate scan (a host sync, where JAX has
lax.cond) and takes the all-masked run on a duplicate, the overlap run
otherwise. Rectangular calls always mask: pos_i may be embedded in pos_j.
Without a duplicate the overlap run is bitwise the masked one, since w feeds
the product unchanged.

CUDA tensors launch B6 (``csrc/mxu_force.cu``), whose tiles are its own (128
receivers per CTA, 128-body j tiles; the (tile_i, tile_j) arguments do not
reach it). CPU tensors take the plain version ``hybrid_sums_plain``, which
walks JAX's (tile_i, tile_j) grid with the same masks and pads as JAX
(``:221-232``: i rows zero, j rows FAR with zero mass, so pads get w = 0
exactly). ``mma_dtype=torch.float32`` multiplies in fp32, as JAX's CPU
interpret run does whatever pair_dtype is; ``torch.bfloat16`` rounds W and
the operand as the tensor cores do, the version B6 is held to on the card.
"""

from __future__ import annotations

import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.ops.sym_mxu_force import any_coincident, resolve_auto
from mini_nbody_tpu_torch.utils.config import (_PAIR_DTYPES, FAR, SOFTENING,
                                               check_coincident,
                                               plain_block_elems, round_up)
from mini_nbody_tpu_torch.utils.tracing import count

#: B6's receivers per CTA and sources per j tile.
KERNEL_TILE = 128

#: B6's coincident gate: below this many bodies a square call's 'auto' is
#: 'masked', without the duplicate scan: the smallest N of chip_smoke.py's
#: coincident_gate phase (4096 .. 262,144) from which the scan plus the
#: overlap run beat the masked run on an H100.
COINCIDENT_AUTO_MIN_N = 131072


def bf16_pairs(pair_dtype: str) -> bool:
    """True for the bf16 class ("bfloat16"), False for "float32"."""
    if pair_dtype not in _PAIR_DTYPES:
        raise ValueError(f"pair_dtype must be one of {_PAIR_DTYPES}, "
                         f"got {pair_dtype!r}")
    return pair_dtype == "bfloat16"


def _operand(pos_j):
    """The compensated split [vhi | vlo] (Nj, 8) of v = [p | 1]."""
    v = torch.cat([pos_j, pos_j.new_ones((pos_j.shape[0], 1))], 1)
    vhi = v.to(torch.bfloat16).float()
    return torch.cat([vhi, v - vhi], 1)


def hybrid_sums_plain(pos_i, pos_j, mass_j=None, softening=SOFTENING,
                      tile_i: int = 512, tile_j: int = 2048,
                      overlap_only: bool = False,
                      pair_dtype: str = "bfloat16", mma_dtype=torch.float32):
    """Plain version of B6: the raw sums S (Ni, 8) [hi | lo] of W @ [p | 1]
    in the bf16 class, or (Ni, 3) sum w d in the fp32 class, over JAX's
    padded (tile_i, tile_j) grid. overlap_only masks d2 == 0 only in tile
    pairs whose i and j ranges meet (square calls with no duplicate);
    otherwise every tile."""
    bf16 = bf16_pairs(pair_dtype)
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    tile_i = min(tile_i, round_up(ni, 8))
    tile_j = min(tile_j, round_up(nj, 128))
    ni_p, nj_p = round_up(ni, tile_i), round_up(nj, tile_j)
    pi, pj = pos_i.float(), pos_j.float()
    pi = torch.cat([pi, pi.new_zeros((ni_p - ni, 3))])
    pj = torch.cat([pj, pj.new_full((nj_p - nj, 3), FAR)])
    mj = None
    if mass_j is not None:
        mj = torch.cat([mass_j.float(), pj.new_zeros(nj_p - nj)])
    v = _operand(pj) if bf16 else None
    if bf16 and mma_dtype == torch.bfloat16:
        v = v.to(torch.bfloat16).float()
    lo_j = torch.arange(nj_p, device=pj.device) // tile_j * tile_j
    rows = max(1, plain_block_elems(pj.device) // nj_p)
    out = []
    for r0 in range(0, ni_p, rows):
        p = pi[r0:r0 + rows]
        dx = pj[None, :, 0] - p[:, None, 0]
        dy = pj[None, :, 1] - p[:, None, 1]
        dz = pj[None, :, 2] - p[:, None, 2]
        d2 = dx * dx + dy * dy + dz * dz
        inv = torch.rsqrt(d2 + softening)
        w = (inv * inv) * inv
        zero = d2 == 0.0
        if overlap_only:
            lo_i = (torch.arange(r0, r0 + p.shape[0], device=pj.device)
                    // tile_i * tile_i)
            zero &= ((lo_i[:, None] < lo_j[None, :] + tile_j)
                     & (lo_j[None, :] < lo_i[:, None] + tile_i))
        w = torch.where(zero, torch.zeros_like(w), w)
        if mj is not None:
            w = w * mj[None, :]
        if not bf16:
            out.append(torch.stack([(w * d).sum(1) for d in (dx, dy, dz)], 1))
            continue
        if mma_dtype == torch.bfloat16:
            w = w.to(torch.bfloat16).float()
        out.append(w @ v)
    return torch.cat(out)[:ni]


def _epilogue(pos_i, s):
    """F from the raw sums: bf16 class, fold the [hi | lo] columns and form
    S[:, :3] - p_i S[:, 3]; fp32 class, the sums are F."""
    if s.shape[1] == 3:
        return s
    s = s[:, 0:4] + s[:, 4:8]
    return s[:, 0:3] - pos_i * s[:, 3:4]


def hybrid_forces(pos_i, pos_j, mass_j=None, softening=SOFTENING,
                  tile_i: int = 512, tile_j: int = 2048,
                  overlap_only: bool = False, pair_dtype: str = "bfloat16",
                  with_sums: bool = False):
    """F (Ni, 3), and with with_sums also the raw sums: CUDA tensors launch
    B6, CPU tensors take hybrid_sums_plain (fp32 products) and the same
    epilogue. pos_i (Ni, 3), pos_j (Nj, 3), mass_j (Nj,) or None, fp32."""
    device = pos_i.device
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    for name, t, shape in (("pos_i", pos_i, (ni, 3)), ("pos_j", pos_j, (nj, 3)),
                           ("mass_j", mass_j, (nj,))):
        if t is not None:
            _build.check_tensor(name, t, shape, torch.float32, device)
    bf16 = bf16_pairs(pair_dtype)
    if not _build.on_card(device):
        s = hybrid_sums_plain(pos_i, pos_j, mass_j, softening, tile_i, tile_j,
                              overlap_only, pair_dtype)
        f = _epilogue(pos_i, s)
        return (f, s) if with_sums else f
    _build.refuse_grad("mxu_force", pos_i, pos_j, mass_j)
    lib = _build.load_library()
    f = torch.empty((ni, 3), dtype=torch.float32, device=device)
    s = (torch.empty((ni, 8 if bf16 else 3), dtype=torch.float32,
                     device=device) if with_sums else None)
    with torch.cuda.device(device):
        code = lib.mxu_force_launch(
            pos_i.data_ptr(), ni, pos_j.data_ptr(),
            None if mass_j is None else mass_j.data_ptr(), nj, f.data_ptr(),
            None if s is None else s.data_ptr(), float(softening),
            int(overlap_only), int(bf16), _build.stream_ptr(device))
    _build.check(lib, code, "mxu_force_launch")
    count("launch.B6")
    return (f, s) if with_sums else f


def square_overlap_only(pos, coincident: str) -> bool:
    """The masking of a square call: True for the overlap run ("fast", or
    "auto" with no duplicate found by the scan), False for the all-masked
    run. Below COINCIDENT_AUTO_MIN_N "auto" is "masked"."""
    coincident = resolve_auto(coincident, pos.shape[0],
                              COINCIDENT_AUTO_MIN_N)
    if coincident == "auto":
        return not any_coincident(pos)
    return coincident == "fast"


def body_force_mxu(pos_i, pos_j, mass_j=None, softening: float = SOFTENING,
                   tile_i: int = 512, tile_j: int = 2048,
                   pair_dtype: str = "bfloat16", coincident: str = "masked"):
    """Forces on pos_i (Ni,3) from (pos_j, mass_j) through the hybrid:
    (Ni,3) fp32. pair_dtype "bfloat16" (the bf16-accumulate class) or
    "float32" (fp32-exact). coincident applies to square calls only
    (pos_j is pos_i): "masked", "fast" (the caller guarantees distinct
    positions; self pairs stay exact) or "auto" (duplicate scan); a
    rectangular call always masks. tile_i / tile_j tile the plain version
    (CPU tensors); the CUDA kernel keeps its own."""
    check_coincident(coincident)
    bf16_pairs(pair_dtype)
    square = pos_i is pos_j
    overlap_only = square and square_overlap_only(pos_i, coincident)
    pi = pos_i.float().contiguous()
    pj = pi if square else pos_j.float().contiguous()
    mj = None if mass_j is None else mass_j.float().contiguous()
    return hybrid_forces(pi, pj, mj, softening, tile_i, tile_j, overlap_only,
                         pair_dtype)
