"""Parameter sweeps: each timed call is one ``sim.simulate_ensemble`` call
of ``systems`` independent systems of ``n`` bodies, ``steps_per_call``
steps from their initial states, all made from the seed.

Every call starts from the same states, so its outputs are the same bits
each time (the port's reproducibility contract); the check compares the
first and the last call bit for bit, and every system of the last call
with the reference's float64 trajectory from the same inputs: the 99th
percentile of its bodies' errors, worst over the systems, so that one
wrong tile of 128 bodies in 4096 shows, while the few bodies that a
close encounter makes chaotic in 10 steps at softening 1e-9 (the maxima,
printed uncompared) do not decide.
"""

from __future__ import annotations

import torch

from portbench import compare, inputs
from portbench.reference import integrate as ri
from portbench.traffic import sim_config


class Driver:
    min_calls = 1

    def __init__(self, config, workload, seed, device, control=False):
        self.config, self.wl = config, workload
        self.n, self.b = workload["n"], workload["systems"]
        self.spc = workload["steps_per_call"]
        self.s0 = inputs.make(config["init"], (self.b, self.n), seed,
                              torch.device(device))
        self.first = self.last = None
        from mini_nbody_tpu_torch import BodyState, sim

        cfg = sim_config(config, self.n, self.spc, control)

        def run():
            out = sim.simulate_ensemble(cfg, BodyState(*self.s0),
                                        steps=self.spc)
            return out.pos, out.vel

        self.run = run

    def warm_up(self):
        self.run()

    def call(self, i):
        out = self.run()
        if i == 0:
            self.first = out
        self.last = out

    def release(self):
        pass

    def check(self):
        pos, vel = self.last
        worst = {"x_err.max": 0.0, "x_err.p99": 0.0, "v_err.max": 0.0,
                 "v_err.p99": 0.0}
        for k in range(self.b):
            x_ref, v_ref = ri.run(*(t[k].double() for t in self.s0),
                                  self.config, self.spc,
                                  ri.Pairs(torch.float64))
            dx = x_ref - self.s0[0][k].double()
            dv = v_ref - self.s0[1][k].double()
            for key, val in (
                    ("x_err.max", compare.worst_row(pos[k], x_ref, dx)),
                    ("x_err.p99",
                     compare.quantile_row(pos[k], x_ref, dx, 0.99)),
                    ("v_err.max", compare.worst_row(vel[k], v_ref, dv)),
                    ("v_err.p99",
                     compare.quantile_row(vel[k], v_ref, dv, 0.99))):
                worst[key] = max(worst[key], val)
        worst["repeat_diff"] = sum(compare.mismatches(a, b)
                                   for a, b in zip(self.first, self.last))
        return worst
