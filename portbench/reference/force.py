"""Softened gravity in plain PyTorch: the force, its VJP and the potential.

With d_kj = x_j - x_k, s = |d|^2 + eps, w = s^-3/2 and u = s^-5/2:

    F_k  = sum_j m_j w_kj d_kj
    U    = -1/2 sum_{k != j} m_k m_j s^-1/2
    for a cotangent g, dL/dx_k of L = sum_k g_k . F_k is
         -g_k sum_j m_j w_kj + m_k sum_j w_kj g_j
         + 3 sum_j u_kj (m_j g_k . d_kj + m_k g_j . d_jk) d_kj

The self pair adds nothing (d = 0). ``*_plain`` materialise d for a block
of rows: the formulas as written, for small n and for the tests.
``accel``, ``accel_vjp`` and ``potential`` evaluate the same sums over a
block of rows with matrix products, so that the pair work is a few passes
over a (rows, n) matrix (four for the force, seven for the VJP):

    s      = [x_k, |x_k|^2 + eps, 1] . [-2 x_j, 1, |x_j|^2]
    F_k    = (W @ [m x, m])_k[:3] - x_k (W @ [m x, m])_k[3]

with the diagonal of W (and of the VJP's matrices) set to zero, which is
the self pair's exact term. In float64 the products lose ~1e-16 of |x|^2 to
cancellation, far below what any check here reads. ``dtype`` sets the type
of the pair matrices; the result is returned in the type of x.

``mantissa_bits`` rounds every pair weight to that many mantissa bits with
an unbounded exponent: 3 is fp8 (e4m3) pair weights under an ideal scale,
the precision below bf16 (the controls of the bf16-class cells).
"""

from __future__ import annotations

import torch

#: Elements of one (rows, n) pair matrix, by device type.
BLOCK_ELEMS = {"cuda": 1 << 28, "cpu": 1 << 20}


def _rows_per_block(n: int, device, scale: int = 1) -> int:
    elems = BLOCK_ELEMS.get(torch.device(device).type, 1 << 20) // scale
    return max(1, elems // max(1, n))


def round_mantissa_(t: torch.Tensor, bits: int) -> torch.Tensor:
    """Round the positive values of t in place to ``bits`` explicit
    mantissa bits (nearest, ties to even), keeping their exponent: on the
    bits, add half of the dropped part (less one, plus the kept last bit)
    and clear it; a carry moves into the exponent as rounding should."""
    itype, mant = {torch.float32: (torch.int32, 23),
                   torch.float64: (torch.int64, 52)}[t.dtype]
    drop = mant - bits
    i = t.view(itype)
    r = i >> drop
    r.bitwise_and_(1).add_((1 << (drop - 1)) - 1)
    i.add_(r).bitwise_and_(~((1 << drop) - 1))
    return t


def _feats(x, eps):
    """Row and column features of s = |x_k - x_j|^2 + eps as one product."""
    sq = (x * x).sum(-1, keepdim=True)
    one = torch.ones_like(sq)
    rows = torch.cat([x, sq + eps, one], dim=1)
    cols = torch.cat([-2.0 * x, one, sq], dim=1)
    return rows, cols


def _zero_self(mat, rows):
    """Zero the self pairs of a block of rows: row k, column rows[k]."""
    mat[torch.arange(mat.shape[0], device=mat.device), rows] = 0.0


def accel(x, m, eps, rows=None, dtype=torch.float64, mantissa_bits=None):
    """F on the bodies ``rows`` (all when None) from all n bodies x (n, 3)
    with masses m (n,): (len(rows), 3) in x's type."""
    n = x.shape[0]
    xd, md = x.to(dtype), m.to(dtype)
    rows_f, cols_f = _feats(xd, eps)
    v = torch.cat([md[:, None] * xd, md[:, None]], dim=1)
    idx_all = (torch.arange(n, device=x.device) if rows is None
               else rows.to(x.device))
    step = _rows_per_block(n, x.device)
    out = []
    for r0 in range(0, idx_all.shape[0], step):
        idx = idx_all[r0:r0 + step]
        w = (rows_f[idx] @ cols_f.T).pow_(-1.5)
        _zero_self(w, idx)
        if mantissa_bits is not None:
            round_mantissa_(w, mantissa_bits)
        s = w @ v
        del w
        out.append(s[:, :3] - xd[idx] * s[:, 3:])
    return torch.cat(out).to(x.dtype)


def accel_vjp(x, m, g, eps, dtype=torch.float64, mantissa_bits=None):
    """dL/dx for L = sum_k g_k . F_k(x), all n bodies: (n, 3) in x's
    type.

    The pair term 3 sum_c u_kc r_kc d_kc has r_kc = a_k . b_c with
    a = [g, -g.x, m x, -m] and b = [m x, m, g, g.x] (8 features each), so
    sum_c u_kc r_kc [x_c, 1] = sum_f a_kf (U @ (b_f [x, 1]))_k: one product
    of U with an (n, 32) matrix, and no (rows, n) matrix but s, W and U."""
    n = x.shape[0]
    xd, md, gd = x.to(dtype), m.to(dtype), g.to(dtype)
    rows_f, cols_f = _feats(xd, eps)
    gm = torch.cat([gd, md[:, None]], dim=1)
    gx = (gd * xd).sum(-1, keepdim=True)
    a = torch.cat([gd, -gx, md[:, None] * xd, -md[:, None]], dim=1)
    b = torch.cat([md[:, None] * xd, md[:, None], gd, gx], dim=1)
    x1 = torch.cat([xd, torch.ones_like(gx)], dim=1)
    bx = (b[:, :, None] * x1[:, None, :]).reshape(n, 32)
    step = _rows_per_block(n, x.device, scale=2)
    out = []
    for r0 in range(0, n, step):
        idx = torch.arange(r0, min(n, r0 + step), device=x.device)
        s = rows_f[idx] @ cols_f.T
        w = s.pow(-1.5)
        u = s.pow_(-2.5)
        _zero_self(w, idx)
        _zero_self(u, idx)
        if mantissa_bits is not None:
            round_mantissa_(w, mantissa_bits)
            round_mantissa_(u, mantissa_bits)
        lin = w @ gm
        del w
        t = (u @ bx).view(-1, 8, 4)
        del u, s
        q = (a[idx, :, None] * t).sum(1)
        out.append(-gd[idx] * lin[:, 3:] + md[idx, None] * lin[:, :3]
                   + 3.0 * (q[:, :3] - xd[idx] * q[:, 3:]))
    return torch.cat(out).to(x.dtype)


def potential(x, m, eps, dtype=torch.float64):
    """U = -1/2 sum_{k != j} m_k m_j (|d|^2 + eps)^-1/2, a float64 0-dim
    tensor."""
    n = x.shape[0]
    xd, md = x.to(dtype), m.to(dtype)
    rows_f, cols_f = _feats(xd, eps)
    step = _rows_per_block(n, x.device)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0 in range(0, n, step):
        idx = torch.arange(r0, min(n, r0 + step), device=x.device)
        phi = (rows_f[idx] @ cols_f.T).rsqrt_()
        _zero_self(phi, idx)
        total -= 0.5 * (md[idx] * (phi @ md)).sum().double()
    return total


def kinetic(v, m):
    """1/2 sum m |v|^2 in float64."""
    return 0.5 * (m.double() * (v.double() ** 2).sum(-1)).sum()


def accel_plain(xi, xj, mj, eps):
    """F on xi (k, 3) from xj (n, 3), mj (n,): the pairwise formula with
    every d materialised, in the inputs' type."""
    d = xj[None, :, :] - xi[:, None, :]
    s = (d * d).sum(-1) + eps
    w = s.rsqrt() ** 3 * mj[None, :]
    w = torch.where((d == 0).all(-1), torch.zeros_like(w), w)
    return (d * w[..., None]).sum(1)


def potential_plain(x, m, eps):
    """U by the pairwise formula, every pair materialised."""
    d = x[None, :, :] - x[:, None, :]
    s = (d * d).sum(-1) + eps
    phi = s.rsqrt()
    phi.fill_diagonal_(0.0)
    return -0.5 * (m[:, None] * m[None, :] * phi).sum()
