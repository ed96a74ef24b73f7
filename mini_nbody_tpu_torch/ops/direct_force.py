"""Ordered all-pairs force: the ``"direct"`` backend, and its fused Euler step.

Counterpart of ``mini_nbody_tpu/ops/pallas_force.py:44-89`` (``_direct_kernel``),
``:219-300`` (``body_force_pallas``), ``:92-128`` (``_fused_euler_kernel``)
and ``:135-212`` (``euler_step_fused``). ``body_force_direct`` launches the
hand-written CUDA kernel ``csrc/direct_force.cu`` (K1) for CUDA tensors and
takes ``direct_force_plain``, the same arithmetic in PyTorch, for CPU
tensors. Rectangular ``(Ni, Nj)``, so later ring exchanges can reuse it.
``euler_step_fused`` launches K5, K1 with a semi-implicit Euler epilogue in
the same source, so the force never reaches device memory; its plain
version is ``euler_step_fused_plain``. Its output is out of place, as JAX's.

``row_schedule`` maps ``block`` onto the kernels' rows a thread and rows a
CTA, and ``rsqrt_form`` picks the rsqrt instantiation from the softening;
K4 (``pe_kernel.py``) takes both too. Neither changes a bit of the output.
"""

from __future__ import annotations

import numpy as np
import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.utils.config import (SOFTENING, fast_rsqrt_cube,
                                               plain_block_elems)
from mini_nbody_tpu_torch.utils.tracing import count

#: The smallest normal fp32. From a softening of FLT_MIN every r2 is normal,
#: so rsqrt.approx.ftz gives rsqrtf's bits without its denormal rescaling.
FLT_MIN = 2.0 ** -126
#: The rsqrt forms of K1, K4 and K5 (csrc/direct_force.cu): rsqrtf of r2,
#: rsqrt.approx.ftz of r2, rsqrt.approx.ftz of r2^3.
FORM_RSQRTF, FORM_NORMAL, FORM_CUBE = 0, 1, 2
#: Rows a thread that row_schedule tries, the largest first.
ROWS_A_THREAD = (4, 2, 1)
#: Threads a grid keeps before a thread takes more rows (row_schedule):
#: ~31 warps on each of an H100's 132 SMs. With fewer, the rsqrt's latency
#: shows (PERF.md: K5 at 65,536 rows, K4 at 262,144).
FILL_THREADS = 131072


def rsqrt_form(softening, cube: bool = True) -> int:
    """The kernels' rsqrt form at ``softening``: FORM_CUBE under
    fast_rsqrt_cube (r2^3 >= 1e-36; ``cube`` False for K4, whose rsqrt is
    of r2), else FORM_NORMAL where the fp32 softening is at least FLT_MIN
    (every r2 >= softening is normal), else FORM_RSQRTF. Each gives
    rsqrtf's bits; the kernels refuse a form that does not hold."""
    if cube and fast_rsqrt_cube(softening):
        return FORM_CUBE
    return FORM_NORMAL if np.float32(softening) >= FLT_MIN else FORM_RSQRTF


def row_schedule(n: int, block: int):
    """(R, rows) of a K1, K4 or K5 launch over n rows at ``block``: rows a
    CTA (and j tile) = block, R rows a thread the largest of ROWS_A_THREAD
    that keeps whole warps (block % (32 R) == 0) and leaves the grid at
    least FILL_THREADS threads."""
    for r in ROWS_A_THREAD:  # ends with 1, which always fits
        if r == 1 or (block % (32 * r) == 0 and
                      -(-n // block) * (block // r) >= FILL_THREADS):
            return r, block


def direct_force_plain(pos_i, pos_j, mass_j=None,
                       softening: float = SOFTENING):
    """The kernel's arithmetic in PyTorch, in row blocks: r2 = dx^2 + dy^2 +
    (dz^2 + softening), w = rsqrt(r2^3) when fast_rsqrt_cube(softening)
    else rsqrt(r2)^3, times m_j in mass mode."""
    fast = fast_rsqrt_cube(softening)
    rows = max(1, plain_block_elems(pos_i.device) // max(1, pos_j.shape[0]))
    xj, yj, zj = pos_j[:, 0], pos_j[:, 1], pos_j[:, 2]
    out = []
    for r in range(0, pos_i.shape[0], rows):
        pi = pos_i[r:r + rows]
        dx = xj[None, :] - pi[:, 0:1]
        dy = yj[None, :] - pi[:, 1:2]
        dz = zj[None, :] - pi[:, 2:3]
        r2 = dx * dx + dy * dy + (dz * dz + softening)
        if fast:
            w = torch.rsqrt((r2 * r2) * r2)
        else:
            inv = torch.rsqrt(r2)
            w = (inv * inv) * inv
        if mass_j is not None:
            w = w * mass_j[None, :]
        out.append(torch.stack([(dx * w).sum(1), (dy * w).sum(1),
                                (dz * w).sum(1)], dim=1))
    if not out:
        return pos_i.new_zeros((0, 3))
    return torch.cat(out)


def body_force_direct(pos_i, pos_j, mass_j=None,
                      softening: float = SOFTENING, block: int = 256):
    """Forces on pos_i (Ni,3) from sources pos_j (Nj,3) with masses mass_j
    ((Nj,), None = unit masses): (Ni,3) fp32.

    CPU tensors take direct_force_plain. CUDA tensors launch K1 with
    ``block`` rows per CTA (a multiple of 32 up to 1024; each CTA stages j
    in tiles of that size, row_schedule picks its rows a thread) or raise,
    as they do when an input requires grad under grad mode
    (``_build.refuse_grad``)."""
    device = pos_i.device
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    f32 = torch.float32
    _build.check_tensor("pos_i", pos_i, (ni, 3), f32, device)
    _build.check_tensor("pos_j", pos_j, (nj, 3), f32, device)
    if mass_j is not None:
        _build.check_tensor("mass_j", mass_j, (nj,), f32, device)
    if not _build.on_card(device):
        return direct_force_plain(pos_i, pos_j, mass_j, softening)
    _check_block(block)
    _build.refuse_grad("body_force_direct", pos_i, pos_j, mass_j)
    return launch_direct(pos_i, pos_j, mass_j, softening,
                         *row_schedule(ni, block))


def launch_direct(pos_i, pos_j, mass_j, softening, r: int, rows: int):
    """K1 at an explicit schedule: r rows a thread, ``rows`` rows a CTA and
    j tile (the kernel refuses r outside (1, 2, 4) and rows not a multiple
    of 32 r up to 1024). CUDA tensors, checked by the caller; the bits do
    not depend on (r, rows). Counted as launch.K1."""
    device = pos_i.device
    lib = _build.load_library()
    out = torch.empty((pos_i.shape[0], 3), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        code = lib.direct_force_launch(
            pos_i.data_ptr(), pos_i.shape[0], pos_j.data_ptr(),
            None if mass_j is None else mass_j.data_ptr(), pos_j.shape[0],
            out.data_ptr(), float(softening), rsqrt_form(softening), r, rows,
            _build.stream_ptr(device))
    _build.check(lib, code, "direct_force_launch")
    count("launch.K1")
    return out


def _check_block(block):
    if block % 32 != 0 or not 32 <= block <= 1024:
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], "
                         f"got {block}")


def euler_step_fused_plain(pos, vel, mass=None, dt: float = 0.01,
                           softening: float = SOFTENING):
    """K5's arithmetic in PyTorch: v' = v + dt F(pos), p' = p + dt v'."""
    vel = vel + dt * direct_force_plain(pos, pos, mass, softening)
    return pos + dt * vel, vel


def euler_step_fused(pos, vel, mass=None, dt: float = 0.01,
                     softening: float = SOFTENING, block: int = 256):
    """One fused force + semi-implicit Euler step of the self-forces of pos
    (N,3), vel (N,3), masses (N,) or None: (pos', vel'), new tensors.

    CPU tensors take euler_step_fused_plain. CUDA tensors launch K5 with
    ``block`` rows per CTA (as body_force_direct) or raise."""
    device = pos.device
    n = pos.shape[0]
    f32 = torch.float32
    _build.check_tensor("pos", pos, (n, 3), f32, device)
    _build.check_tensor("vel", vel, (n, 3), f32, device)
    if mass is not None:
        _build.check_tensor("mass", mass, (n,), f32, device)
    if not _build.on_card(device):
        return euler_step_fused_plain(pos, vel, mass, dt, softening)
    _check_block(block)
    _build.refuse_grad("euler_step_fused", pos, vel, mass)
    return launch_fused(pos, vel, mass, dt, softening,
                        *row_schedule(n, block))


def launch_fused(pos, vel, mass, dt, softening, r: int, rows: int):
    """K5 at an explicit schedule (as launch_direct): (pos', vel'),
    counted as launch.K5."""
    device = pos.device
    lib = _build.load_library()
    pos_out, vel_out = torch.empty_like(pos), torch.empty_like(vel)
    with torch.cuda.device(device):
        code = lib.direct_euler_launch(
            pos.data_ptr(), vel.data_ptr(),
            None if mass is None else mass.data_ptr(), pos.shape[0],
            pos_out.data_ptr(), vel_out.data_ptr(), float(softening),
            float(dt), rsqrt_form(softening), r, rows,
            _build.stream_ptr(device))
    _build.check(lib, code, "direct_euler_launch")
    count("launch.K5")
    return pos_out, vel_out
