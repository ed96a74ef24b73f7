"""The gradient users' loop: gradient descent on the initial positions of
one system through a checkpointed leapfrog rollout.

Each timed call is one iteration, as ``examples/torch/optimize_impact.py``
builds it: the opening acceleration from ``sim.init_carry`` outside the
gradient, a ``steps_per_call``-step rollout from ``sim.make_rollout_fn``,
the loss sum |v|^2 of the final velocities, its backward to the initial
positions and the update x <- x - lr grad. Set-up
runs one iteration from the seed's state and keeps nothing of it; the
window's iterations then continue from the seed's state, one object
throughout.

The check is a training step's: the reference follows the first
``follow`` iterations from the same inputs in float64 and compares each
iteration's loss, the first gradient as the update applied it (from the
positions after one iteration), the positions' change after ``follow``
iterations, and the first gradient itself, all of it the force VJPs'
work. A loss on the final positions would leave them ~3 parts in 10^5 of
its gradient at 262,144 bodies (2 x_f is the rest), under fp32's rounding
of that rest, so that no number tells the program from its control.
"""

from __future__ import annotations

import torch

from portbench import compare, inputs
from portbench.reference import integrate as ri
from portbench.traffic import reference_control, sim_config


class Driver:
    def __init__(self, config, workload, seed, device, control=False):
        self.config, self.wl = config, workload
        self.n, self.spc = workload["n"], workload["steps_per_call"]
        self.lr, self.follow = workload["lr"], workload["check"]["follow"]
        self.min_calls = self.follow
        self.s0 = inputs.make(config["init"], self.n, seed,
                              torch.device(device))
        self.x = self.s0[0]
        self.losses, self.xs = [], [self.s0[0]]
        self.grad0 = None
        pairs = reference_control(config) if control else None
        if pairs is not None:
            c = config

            def iterate(x):
                return ri.rollout_grad(
                    x, self.s0[1], self.s0[2], c["softening"], c["dt"],
                    self.spc, pairs)
        else:
            from mini_nbody_tpu_torch import BodyState, sim

            cfg = sim_config(config, self.n, self.spc, control)
            rollout = sim.make_rollout_fn(cfg, self.spc, workload["remat"])
            vel, mass = self.s0[1], self.s0[2]

            def iterate(x):
                with torch.no_grad():
                    acc0 = sim.init_carry(cfg, BodyState(x, vel, mass))[1]
                p = x.detach().requires_grad_(True)
                out, _ = rollout((BodyState(p, vel, mass), acc0))
                loss = self.loss_fn(out.vel)
                loss.backward()
                return loss.detach(), p.grad

        self.iterate = iterate

    @staticmethod
    def loss_fn(y):
        return (y * y).sum()

    def warm_up(self):
        self.iterate(self.s0[0])

    def call(self, i):
        loss, grad = self.iterate(self.x)
        with torch.no_grad():
            self.x = self.x - self.lr * grad
        if i < self.follow:
            self.losses.append(loss)
            self.xs.append(self.x)
        if i == 0:
            self.grad0 = grad

    def release(self):
        self.x = None

    def check(self):
        c, f = self.config, self.follow
        x0, v0, m = (t.double() for t in self.s0)
        lr = self.wl["lr"]
        ref = ri.descend(x0, v0, m, c["softening"], c["dt"], self.spc, lr,
                         f, ri.Pairs(torch.float64))
        out = {f"loss_gap.{k}": compare.relative_gap(self.losses[k].item(),
                                                     ref["losses"][k].item())
               for k in range(f)}
        applied = (x0 - self.xs[1].double()) / lr
        out["grad_norm_gap"] = compare.relative_gap(
            applied.norm().item(), ref["grads"][0].norm().item())
        out["change_norm_gap"] = compare.relative_gap(
            (self.xs[f].double() - x0).norm().item(),
            (ref["xs"][f] - x0).norm().item())
        out["grad_err"] = ((self.grad0.double() - ref["grads"][0]).norm()
                           / ref["grads"][0].norm()).item()
        return out
