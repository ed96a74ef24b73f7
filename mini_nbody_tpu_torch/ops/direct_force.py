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
"""

from __future__ import annotations

import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.utils.config import (SOFTENING, fast_rsqrt_cube,
                                               plain_block_elems)

#: Kernel launches made by body_force_direct (CUDA tensors only).
LAUNCHES = 0
#: Kernel launches made by euler_step_fused (CUDA tensors only).
FUSED_LAUNCHES = 0


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
    ``block`` threads per block (a multiple of 32 up to 1024; each block
    stages j in tiles of that size) or raise."""
    device = pos_i.device
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    f32 = torch.float32
    _build.check_tensor("pos_i", pos_i, (ni, 3), f32, device)
    _build.check_tensor("pos_j", pos_j, (nj, 3), f32, device)
    if mass_j is not None:
        _build.check_tensor("mass_j", mass_j, (nj,), f32, device)
    if device.type == "cpu":
        return direct_force_plain(pos_i, pos_j, mass_j, softening)
    _check_cuda(device, block)
    global LAUNCHES
    lib = _build.load_library()
    out = torch.empty((ni, 3), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = lib.direct_force_launch(
            pos_i.data_ptr(), ni, pos_j.data_ptr(),
            None if mass_j is None else mass_j.data_ptr(), nj,
            out.data_ptr(), float(softening), int(fast_rsqrt_cube(softening)),
            block, _build.stream_ptr(device))
    _build.check(lib, code, "direct_force_launch")
    LAUNCHES += 1
    return out


def _check_cuda(device, block):
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
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
    ``block`` threads per block (as body_force_direct) or raise."""
    device = pos.device
    n = pos.shape[0]
    f32 = torch.float32
    _build.check_tensor("pos", pos, (n, 3), f32, device)
    _build.check_tensor("vel", vel, (n, 3), f32, device)
    if mass is not None:
        _build.check_tensor("mass", mass, (n,), f32, device)
    if device.type == "cpu":
        return euler_step_fused_plain(pos, vel, mass, dt, softening)
    _check_cuda(device, block)
    global FUSED_LAUNCHES
    lib = _build.load_library()
    pos_out, vel_out = torch.empty_like(pos), torch.empty_like(vel)
    with torch.cuda.device(device):
        code = lib.direct_euler_launch(
            pos.data_ptr(), vel.data_ptr(),
            None if mass is None else mass.data_ptr(), n, pos_out.data_ptr(),
            vel_out.data_ptr(), float(softening), float(dt),
            int(fast_rsqrt_cube(softening)), block, _build.stream_ptr(device))
    _build.check(lib, code, "direct_euler_launch")
    FUSED_LAUNCHES += 1
    return pos_out, vel_out
