"""The Euler and leapfrog updates, and the gradient-descent loop of the
gradient cell, over the reference force.

The updates are mini-nbody's and the port's documented semantics:
semi-implicit Euler (v += dt F(x), then x += dt v) and kick-drift-kick
leapfrog carrying the acceleration. The gradient of a rollout is plain
autograd through the updates, with the force as an autograd function
whose backward is ``force.accel_vjp``.
"""

from __future__ import annotations

import torch

from portbench.reference import force as rf


class Pairs:
    """How the reference evaluates pair sums: the type of its pair matrices
    and, for a control, the mantissa bits its pair weights keep."""

    def __init__(self, dtype=torch.float64, mantissa_bits=None):
        self.dtype = dtype
        self.mantissa_bits = mantissa_bits

    def accel(self, x, m, eps, rows=None):
        return rf.accel(x, m, eps, rows=rows, dtype=self.dtype,
                        mantissa_bits=self.mantissa_bits)

    def vjp(self, x, m, g, eps):
        return rf.accel_vjp(x, m, g, eps, dtype=self.dtype,
                            mantissa_bits=self.mantissa_bits)


class _Accel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, eps, pairs):
        ctx.save_for_backward(x, m)
        ctx.eps, ctx.pairs = eps, pairs
        return pairs.accel(x.detach(), m, eps)

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        return ctx.pairs.vjp(x, m, g, ctx.eps), None, None, None


def accel(x, m, eps, pairs: Pairs):
    """The force on all bodies, differentiable in x."""
    return _Accel.apply(x, m, eps, pairs)


def euler(x, v, m, eps, dt, steps, pairs: Pairs):
    """``steps`` semi-implicit Euler steps: (x, v)."""
    for _ in range(steps):
        v = v + dt * pairs.accel(x, m, eps)
        x = x + dt * v
    return x, v


def leapfrog(x, v, m, eps, dt, steps, pairs: Pairs, acc=None):
    """``steps`` kick-drift-kick steps from (x, v), acc = F(x) (computed
    when None): (x, v, acc)."""
    if acc is None:
        acc = accel(x, m, eps, pairs)
    half = 0.5 * dt
    for _ in range(steps):
        vh = v + half * acc
        x = x + dt * vh
        acc = accel(x, m, eps, pairs)
        v = vh + half * acc
    return x, v, acc


def run(x, v, m, config: dict, steps: int, pairs: Pairs):
    """``steps`` steps of the configuration's integrator (euler or
    leapfrog, the opening acceleration computed) from (x, v): (x, v)."""
    eps, dt = config["softening"], config["dt"]
    with torch.no_grad():
        if config["integrator"] == "euler":
            return euler(x, v, m, eps, dt, steps, pairs)
        return leapfrog(x, v, m, eps, dt, steps, pairs)[:2]


def rollout_grad(x0, v0, m, eps, dt, steps, pairs: Pairs):
    """The gradient cell's iteration: the opening acceleration held
    constant, a ``steps``-step leapfrog rollout, the loss sum |v|^2 of the
    final velocities and its gradient in x0: (loss, grad)."""
    with torch.no_grad():
        acc0 = pairs.accel(x0, m, eps)
    x = x0.detach().clone().requires_grad_(True)
    _, vf, _ = leapfrog(x, v0, m, eps, dt, steps, pairs, acc=acc0)
    loss = (vf * vf).sum()
    loss.backward()
    return loss.detach(), x.grad.detach()


def descend(x0, v0, m, eps, dt, steps, lr, iters, pairs: Pairs):
    """``iters`` gradient-descent iterations x <- x - lr grad from x0:
    {"losses", "grads", "xs"} with xs[0] = x0."""
    out = {"losses": [], "grads": [], "xs": [x0]}
    x = x0
    for _ in range(iters):
        loss, grad = rollout_grad(x, v0, m, eps, dt, steps, pairs)
        x = (x - lr * grad).detach()
        out["losses"].append(loss)
        out["grads"].append(grad)
        out["xs"].append(x)
    return out
