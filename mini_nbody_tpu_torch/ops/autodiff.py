"""Differentiable force op: the analytic VJP over the port's force backends.

Counterpart of ``mini_nbody_tpu/ops/autodiff.py:1-264``. The force kernels
have no automatic derivative, but softened gravity has a clean analytic
one. With d_kj = p_j - p_k, s = |d|^2 + eps, w = s^-3/2, u = s^-5/2 and
L = sum_k g_k . F_k:

  receiver (i = k):  dL/dp_k += sum_j m_j [ -w g_k + 3 u (g_k . d) d ]
  source   (j = k):  dL/dp_k += m_k sum_i [  w g_i - 3 u (g_i . d) d ]

The self term cancels analytically but not in fp32 (w = eps^-1.5 ~ 3e13 at
the default softening), so w and u are zeroed where the pre-softening
|d|^2 == 0; the self pair's true contribution is zero.

``make_body_force_diff`` wraps a non-differentiable square force in a
``torch.autograd.Function`` whose backward is a kernel, routed by
precision class; a CPU tensor also routes by ``_SYM_BWD_MAX``, as JAX's
``_bwd`` (``autodiff.py:153-222``) does:

  backward | N <= _SYM_BWD_MAX, or any N | N > _SYM_BWD_MAX on a CPU
           | on a CUDA tensor            | tensor
  "fp32"   | vjp_pos_sym (B11)           | vjp_pos_direct (B10)
  "bf16"   | vjp_pos_sym_mxu (B13)       | vjp_rect_mxu square (B14)
  "torch"  | _vjp_pos (chunked PyTorch, JAX's backward="jnp"), any N

(JAX's "pallas" and "mxu" backwards are "fp32" and "bf16" here.)
``_SYM_BWD_MAX`` is the TPU's VMEM limit for its pair-once backwards; a
CPU tensor keeps it, so that the routing, and so the arithmetic, match
JAX's. The card's pair-once backwards run on K3's chunked slot geometry
and have no single-launch bound, and on an H100 they beat the ordered
ones at every N measured, 65,536 to 1,048,576, with masses and unit
masses (B13 against B14, B11 against B10: ``ab_slots.py --only
bwdmax``), so a CUDA tensor takes B11 or B13 at every N (ROADMAP C),
with the mass cotangent when mass_grad asks for it, and B13's 'auto'
never scans for duplicates. mass_grad beyond the bound on a CPU tensor,
which JAX sends to the chunked jnp VJP because its ordered kernels have
no mass output, takes ``_vjp_pos`` as JAX does. Without mass_grad the
mass cotangent is zeros, as in JAX. B10 and B14 stay reachable through
their wrappers.

``make_differentiable_ensemble_force`` (``autodiff.py:267-336``) is the
same for B independent systems: the forward is the ensemble force (B9a on
``sym_mxu``, B9b on ``sym``) and the backward the ensemble VJP of the same
precision class (B9d, B9c), block-diagonal over the systems, so each
system's gradient is its own standalone backward's.
"""

from __future__ import annotations

import torch

from mini_nbody_tpu_torch import _build
from mini_nbody_tpu_torch.utils.tracing import annotate, count

#: Bound of the pair-once backward kernels in JAX (the (ko, N) VMEM
#: reaction buffer); beyond it the ordered backwards take over. The route
#: of a CPU tensor only (module docstring).
_SYM_BWD_MAX = 131072

BACKWARDS = ("torch", "fp32", "bf16")


def _vjp_pos(pos, g, mass, softening, row_chunk: int | None = None,
             with_mass_grad: bool = False):
    """pos_bar for cotangent g of F(pos), square and self-interacting, in
    row chunks of PyTorch (memory O(row_chunk * N)). with_mass_grad also
    returns mass_bar: dF_j/dm_k = w_jk d_jk, so mass_bar_k =
    -sum_j w (g_j . d_kj) with the same d and w."""
    n = pos.shape[0]
    if row_chunk is None:
        row_chunk = max(8, min(2048, (1 << 24) // max(n, 1)))
    out, mass_out = [], []
    for r in range(0, n, row_chunk):
        pos_c, g_c, m_c = (pos[r:r + row_chunk], g[r:r + row_chunk],
                           mass[r:r + row_chunk])
        d = pos[None, :, :] - pos_c[:, None, :]  # d[k, j] = p_j - p_k
        d2 = (d * d).sum(-1)
        inv = torch.rsqrt(d2 + softening)
        inv2 = inv * inv
        w = inv2 * inv
        u = w * inv2
        zero = d2 == 0.0
        w = torch.where(zero, torch.zeros_like(w), w)
        u = torch.where(zero, torch.zeros_like(u), u)
        m_w = mass[None, :] * w
        m_u = mass[None, :] * u
        dot_gk_d = (g_c[:, None, :] * d).sum(-1)
        t_recv = (-m_w.sum(1, keepdim=True) * g_c
                  + 3.0 * ((m_u * dot_gk_d)[:, :, None] * d).sum(1))
        dot_gi_d = (g[None, :, :] * d).sum(-1)
        t_src = m_c[:, None] * (
            w @ g - 3.0 * ((u * dot_gi_d)[:, :, None] * d).sum(1))
        out.append(t_recv + t_src)
        if with_mass_grad:
            mass_out.append(-(w * dot_gi_d).sum(1))
    pos_bar = torch.cat(out) if out else pos.new_zeros((0, 3))
    if with_mass_grad:
        return pos_bar, (torch.cat(mass_out) if mass_out
                         else mass.new_zeros((0,)))
    return pos_bar


def _route(pos, g, mass, softening, backward, unit_mass, block, mass_grad,
           sym_bwd_tile, coincident):
    """(pos_bar, mass_bar or None) for cotangent g: the JAX routing on a
    CPU tensor; on a CUDA tensor the pair-once backward of the class at
    every N (module docstring). The kernel routed to is counted as
    route.vjp.<kernel> (B10, B11, B13, B14, or torch for the plain
    PyTorch VJP)."""
    from mini_nbody_tpu_torch.ops import vjp_kernel, vjp_mxu

    n = pos.shape[0]
    m = None if unit_mass else mass
    sym_kw = dict(softening=softening, tile=sym_bwd_tile,
                  mass_grad=mass_grad, coincident=coincident)
    if backward != "torch" and (n <= _SYM_BWD_MAX
                                or _build.on_card(pos.device)):
        bf16 = backward == "bf16"
        count("route.vjp.B13" if bf16 else "route.vjp.B11")
        sym = vjp_mxu.vjp_pos_sym_mxu if bf16 else vjp_kernel.vjp_pos_sym
        out = sym(pos, g, m, **sym_kw)
    elif backward != "torch" and not mass_grad:
        count("route.vjp.B14" if backward == "bf16" else "route.vjp.B10")
        if backward == "bf16":
            out = vjp_mxu.vjp_rect_mxu(pos, g, pos, g, m, m,
                                       softening=softening,
                                       coincident=coincident)
        else:
            out = vjp_kernel.vjp_pos_direct(pos, g, m, softening=softening,
                                            block=block,
                                            coincident=coincident)
    else:
        count("route.vjp.torch")
        # Unit masses as the forward took them (JAX's jnp backward uses the
        # passed masses here even when the forward ignored them).
        out = _vjp_pos(pos, g, torch.ones_like(mass) if unit_mass else mass,
                       softening, with_mass_grad=mass_grad)
    return out if mass_grad else (out, None)


class _BodyForceDiff(torch.autograd.Function):
    """forward: the force kernel (no autograd history of its own);
    backward: the routed VJP kernel, one nbody.vjp span."""

    @staticmethod
    def forward(ctx, pos, mass, impl, spec):
        ctx.save_for_backward(pos, mass)
        ctx.spec = spec
        return impl(pos, mass)

    @staticmethod
    def backward(ctx, g):
        with annotate("nbody.vjp"):
            pos, mass = ctx.saved_tensors
            pos_bar, mass_bar = _route(pos, g.contiguous(), mass, **ctx.spec)
            if mass_bar is None and ctx.needs_input_grad[1]:
                mass_bar = torch.zeros_like(mass)
            return pos_bar, mass_bar, None, None


def make_body_force_diff(force_impl, softening: float,
                         backward: str = "torch", unit_mass: bool = False,
                         block: int = 256, mass_grad: bool = False,
                         sym_bwd_tile: int | None = None,
                         coincident: str = "auto"):
    """Wrap ``force_impl(pos, mass) -> (N,3)`` (square self-force, any
    backend, not differentiable) into ``f(pos, mass)`` that autograd
    differentiates: the forward runs the kernel, the backward the analytic
    VJP routed by ``backward`` (module docstring). Gradients flow to pos;
    with mass_grad also to the masses, otherwise the mass cotangent is
    zeros. block is B10's threads per block; sym_bwd_tile the pair-once
    backwards' tile (None = their default); coincident routes their
    off-diagonal d2 == 0 mask (the plain PyTorch VJP always masks)."""
    if backward not in BACKWARDS:
        raise ValueError(f"backward must be one of {BACKWARDS}, "
                         f"got {backward!r}")
    if mass_grad and unit_mass:
        raise ValueError("mass_grad=True requires a mass-mode force "
                         "(unit_mass=False)")
    spec = dict(softening=float(softening), backward=backward,
                unit_mass=unit_mass, block=block, mass_grad=mass_grad,
                sym_bwd_tile=sym_bwd_tile, coincident=coincident)

    def body_force_diff(pos, mass):
        return _BodyForceDiff.apply(pos, mass, force_impl, spec)

    return body_force_diff


def make_differentiable_force(cfg, mass_grad: bool = False):
    """Differentiable ``force(pos, mass=None) -> (N,3)`` over the configured
    backend, for ``loss.backward()`` or ``torch.autograd.grad``: the
    ``torch`` backend takes the plain PyTorch VJP, the bf16 class
    (``sym_mxu``, and ``mxu`` with pair_dtype="bfloat16") the bf16 backward
    kernels, and every other backend (``mxu`` with pair_dtype="float32"
    among them) the fp32 ones, as JAX routes them. mass_grad=True (requires
    cfg.use_masses) also yields gradients with respect to the per-body
    masses."""
    from mini_nbody_tpu_torch.ops.force import make_force_fn

    inner = make_force_fn(cfg)

    def impl(pos, mass):
        return inner(pos, pos, mass)

    eff = cfg.effective_backend()
    if eff == "torch":
        backward = "torch"
    elif cfg.bf16_class():
        backward = "bf16"
    else:
        backward = "fp32"
    diff = make_body_force_diff(
        impl, float(cfg.softening), backward=backward,
        unit_mass=not cfg.use_masses, block=cfg.tile_i, mass_grad=mass_grad,
        sym_bwd_tile=cfg.sym_bwd_tile, coincident=cfg.coincident)

    def force(pos, mass=None):
        if mass is None:
            mass = torch.ones(pos.shape[0], dtype=pos.dtype,
                              device=pos.device)
        return diff(pos, mass)

    return force


class StaticMassForce(torch.autograd.Function):
    """forward: a force fwd(pos, mass) that has no autograd history;
    backward: its VJP bwd(pos, g, mass), one nbody.vjp span. The masses
    are static (no gradient), as in JAX's ensemble and sharded forces. Used
    by make_differentiable_ensemble_force and the sharded step
    (parallel/sharded.py)."""

    @staticmethod
    def forward(ctx, pos, mass, fwd, bwd):
        ctx.save_for_backward(pos, mass)
        ctx.bwd = bwd
        return fwd(pos, mass)

    @staticmethod
    def backward(ctx, g):
        with annotate("nbody.vjp"):
            pos, mass = ctx.saved_tensors
            return ctx.bwd(pos, g.contiguous(), mass), None, None, None


def make_differentiable_ensemble_force(cfg):
    """Differentiable ``force(pos, mass=None) -> (B, N, 3)`` over B
    independent systems (sim.simulate_ensemble's force): forward
    body_force_sym_mxu_ensemble (B9a) for 'sym_mxu' or
    body_force_symmetric_ensemble (B9b) for 'sym' and 'auto'; backward
    vjp_pos_sym_mxu_ensemble (B9d) or vjp_pos_sym_ensemble (B9c), at
    cfg.sym_bwd_tile. Gradients flow to pos only; the masses are static.
    A call is one force pass: one nbody.force span."""
    eff = cfg.effective_backend()
    if eff not in ("sym", "sym_mxu"):
        raise ValueError(
            "ensemble force requires backend='sym_mxu' or 'sym', got "
            f"{eff!r}")
    soft = float(cfg.softening)
    use_masses = cfg.use_masses
    if eff == "sym_mxu":
        from mini_nbody_tpu_torch.ops.sym_mxu_force import (
            body_force_sym_mxu_ensemble)
        from mini_nbody_tpu_torch.ops.vjp_mxu import (
            vjp_pos_sym_mxu_ensemble as vjp_ensemble)

        def fwd(pos, mass):
            return body_force_sym_mxu_ensemble(
                pos, mass if use_masses else None, softening=soft,
                tile=cfg.sym_tile, split_w=cfg.split_w,
                coincident=cfg.coincident)
    else:
        from mini_nbody_tpu_torch.ops.symmetric_force import (
            body_force_symmetric_ensemble)
        from mini_nbody_tpu_torch.ops.vjp_kernel import (
            vjp_pos_sym_ensemble as vjp_ensemble)

        def fwd(pos, mass):
            return body_force_symmetric_ensemble(
                pos, mass if use_masses else None, softening=soft,
                tile=cfg.sym_tile)

    def bwd(pos, g, mass):
        return vjp_ensemble(pos, g, mass if use_masses else None,
                            softening=soft, tile=cfg.sym_bwd_tile,
                            coincident=cfg.coincident)

    def force(pos, mass=None):
        if mass is None:
            mass = torch.ones(pos.shape[:2], dtype=pos.dtype,
                              device=pos.device)
        with annotate("nbody.force"):
            return StaticMassForce.apply(pos, mass, fwd, bwd)

    return force
