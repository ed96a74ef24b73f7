"""The softened potential energy on a kernel.

Counterpart of ``mini_nbody_tpu/ops/pe_kernel.py:31-137`` (``_pe_kernel``,
``potential_energy_pallas``): U = -sum_{i<j} m_i m_j / sqrt(r_ij^2 + eps)
as the ordered row sums row_i = sum_{j != i} m_j rsqrt(r2), the diagonal
masked by global index (distinct coincident bodies keep their eps^-1/2
term), then U = -1/2 sum_i m_i row_i as a PyTorch fp32 sum.
``potential_energy_kernel`` launches the hand-written kernel
``csrc/pe_kernel.cu`` (K4) for CUDA tensors and takes
``potential_energy_plain`` (``pe_rows_plain``, the same arithmetic in
PyTorch, and the same epilogue) for CPU tensors.
"""

from __future__ import annotations

import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.utils.config import SOFTENING, plain_block_elems

#: Kernel launches made by potential_energy_kernel (CUDA tensors only).
LAUNCHES = 0
#: Threads per block of K4, which is also its j-tile size.
BLOCK = 256


def pe_rows_plain(pos, mass=None, softening: float = SOFTENING):
    """The kernel's row sums in PyTorch, in row blocks: (N,) in pos's
    dtype."""
    n = pos.shape[0]
    rows = max(1, plain_block_elems(pos.device) // max(1, n))
    cols = torch.arange(n, device=pos.device)
    out = []
    for r in range(0, n, rows):
        pi = pos[r:r + rows]
        dx = pos[None, :, 0] - pi[:, 0:1]
        dy = pos[None, :, 1] - pi[:, 1:2]
        dz = pos[None, :, 2] - pi[:, 2:3]
        inv = torch.rsqrt(dx * dx + dy * dy + (dz * dz + softening))
        self_pair = cols[None, :] == torch.arange(
            r, r + pi.shape[0], device=pos.device)[:, None]
        inv = torch.where(self_pair, torch.zeros_like(inv), inv)
        if mass is not None:
            inv = inv * mass[None, :]
        out.append(inv.sum(1))
    if not out:
        return pos.new_zeros((0,))
    return torch.cat(out)


def potential_from_rows(rows, mass=None):
    """The epilogue U = -1/2 sum_i m_i row_i, a 0-dim tensor."""
    return -0.5 * torch.sum(rows if mass is None else mass * rows)


def potential_energy_plain(pos, mass=None, softening: float = SOFTENING):
    """U through pe_rows_plain, on any device and dtype."""
    return potential_from_rows(pe_rows_plain(pos, mass, softening), mass)


def potential_energy_kernel(pos, mass=None, softening: float = SOFTENING):
    """U of pos (N,3) with masses (N,) (None = unit masses): a 0-dim fp32
    tensor on pos's device. CUDA tensors launch K4 or raise; CPU tensors
    take potential_energy_plain."""
    device = pos.device
    n = pos.shape[0]
    f32 = torch.float32
    _build.check_tensor("pos", pos, (n, 3), f32, device)
    if mass is not None:
        _build.check_tensor("mass", mass, (n,), f32, device)
    if device.type == "cpu":
        return potential_energy_plain(pos, mass, softening)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    global LAUNCHES
    lib = _build.load_library()
    rows = torch.empty((n,), dtype=f32, device=device)
    with torch.cuda.device(device):
        code = lib.pe_rows_launch(
            pos.data_ptr(), None if mass is None else mass.data_ptr(), n,
            rows.data_ptr(), float(softening), BLOCK,
            _build.stream_ptr(device))
    _build.check(lib, code, "pe_rows_launch")
    LAUNCHES += 1
    return potential_from_rows(rows, mass)
