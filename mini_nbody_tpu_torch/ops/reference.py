"""Plain all-pairs force in PyTorch: the ``"torch"`` backend and the port's
in-package oracle.

Counterpart of ``mini_nbody_tpu/ops/reference.py:29-63``:

    d = p_j - p_i;  r2 = |d|^2 + softening;  F_i = sum_j m_j d rsqrt(r2)^3

Self pairs are computed, not skipped (d = 0 gives exactly zero). It runs in
the dtype of its inputs, so float64 tensors give a float64 oracle.
"""

from __future__ import annotations

import torch

from mini_nbody_tpu_torch.utils.config import SOFTENING


def _force_block(pos_i, pos_j, mass_j, softening):
    """(Ni,3) x (Nj,3) -> (Ni,3), materializing the (Ni, Nj) pair block."""
    d = pos_j[None, :, :] - pos_i[:, None, :]
    dist_sqr = (d * d).sum(-1) + softening
    inv = torch.rsqrt(dist_sqr)
    w = inv * inv * inv * mass_j[None, :]
    return (d * w[:, :, None]).sum(1)


def body_force_torch(pos_i, pos_j, mass_j=None, softening: float = SOFTENING,
                     row_chunk: int | None = None):
    """Forces on pos_i (Ni,3) from sources pos_j (Nj,3) with masses mass_j
    (None = unit masses). row_chunk bounds the (row_chunk, Nj) intermediate;
    unlike the JAX op it need not divide Ni."""
    if mass_j is None:
        mass_j = torch.ones(pos_j.shape[0], dtype=pos_j.dtype,
                            device=pos_j.device)
    ni = pos_i.shape[0]
    if row_chunk is None or row_chunk >= ni:
        return _force_block(pos_i, pos_j, mass_j, softening)
    return torch.cat([_force_block(pos_i[r:r + row_chunk], pos_j, mass_j,
                                   softening)
                      for r in range(0, ni, row_chunk)])
