"""Streamed trajectories of one system through ``sim.simulate``.

Each timed call is ``simulate(cfg, state, steps=steps_per_call)`` from the
previous call's state. With ``restart_every`` the chain starts again from
the seed's state after that many calls (mini-nbody's runs of 10 steps from
``randomizeBodies``, which the repeats also hold to bitwise equality);
without it the chain runs through the whole window, as the CLI's
periodic-checkpoint loop (``--save-every``) chains ``simulate`` calls; each
call pays the opening force pass that one long call would pay once.

The check follows the program step by step from its own states, as no
reference could follow a whole window at these sizes in a run's time: it
recomputes each recorded call from that call's input in float64 and
compares the call's output. ``sample_rows`` (one-step calls only) compares
that many bodies drawn from the seed, all of them on the first call from
the seed's state when ``full_start``; without it every body of the first
and the last call is compared. Each comparison reads the worst body's
error over the median body's change (``dv_err.start``, ...) and the 99th
and 99.9th percentiles of the bodies' errors over the same
(``dv_err.p99.start``, ``dv_err.p999.start``, ...), for a class whose few
bodies in close pairs make the worst row swing from seed to seed; the
workload's ``limits`` say which are compared. ``drift`` holds the window's whole trajectory to the
configuration's energy guarantee, both energies the reference's.
"""

from __future__ import annotations

import torch

from portbench import compare, inputs
from portbench.reference import force as rf
from portbench.reference import integrate as ri
from portbench.traffic import reference_control, sim_config


#: {suffix: compare function}: the worst row, the 99th and the 99.9th
#: percentiles.
STATISTICS = {
    "": compare.worst_row,
    ".p99": lambda got, want, base: compare.quantile_row(got, want, base,
                                                         0.99),
    ".p999": lambda got, want, base: compare.quantile_row(got, want, base,
                                                          0.999),
}


class Driver:
    def __init__(self, config, workload, seed, device, control=False):
        self.config, self.wl, self.seed = config, workload, seed
        self.n, self.spc = workload["n"], workload["steps_per_call"]
        self.restart = workload.get("restart_every")
        self.device = torch.device(device)
        self.s0 = inputs.make(config["init"], self.n, seed, self.device)
        self.first, self.repeats, self.last = {}, {}, None
        self.cur = None
        self.min_calls = self.restart or 2
        pairs = reference_control(config) if control else None
        if pairs is not None:
            self.run = lambda pos, vel, mass: ri.run(pos, vel, mass, config,
                                                     self.spc, pairs)
        else:
            from mini_nbody_tpu_torch import BodyState, sim

            cfg = sim_config(config, self.n, self.spc, control)

            def run(pos, vel, mass):
                out = sim.simulate(cfg, BodyState(pos, vel, mass),
                                   steps=self.spc)
                return out.pos, out.vel

            self.run = run

    def warm_up(self):
        self.run(*self.s0)

    def call(self, i):
        phase = i % self.restart if self.restart else i
        pos, vel, mass = self.s0
        if phase != 0:
            pos, vel = self.cur
        out = self.run(pos, vel, mass)
        if i < (self.restart or 1):
            self.first[phase] = ((pos, vel), out)
        elif self.restart:
            self.repeats[phase] = out
        self.last = ((pos, vel), out)
        self.cur = out

    def release(self):
        self.cur = None

    def _follow(self, pos, vel, rows=None):
        """The reference's call from (pos, vel) in float64: the outputs of
        ``rows`` (all bodies when None; rows need a one-step Euler call)."""
        c, mass = self.config, self.s0[2].double()
        x, v = pos.double(), vel.double()
        pairs = ri.Pairs(torch.float64)
        with torch.no_grad():
            if rows is not None:
                a = pairs.accel(x, mass, c["softening"], rows=rows)
                v_new = v[rows] + c["dt"] * a
                return x[rows] + c["dt"] * v_new, v_new
        return ri.run(x, v, mass, c, self.spc, pairs)

    def _compare(self, record, rows=None):
        """{suffix: (velocity error, position error)} of one recorded
        call, for each of ``STATISTICS``."""
        (pos, vel), (pos_out, vel_out) = record
        x_ref, v_ref = self._follow(pos, vel, rows)
        if rows is None:
            rows = slice(None)
        sides = ((vel_out[rows], v_ref, v_ref - vel[rows].double()),
                 (pos_out[rows], x_ref, x_ref - pos[rows].double()))
        return {suffix: tuple(f(*side) for side in sides)
                for suffix, f in STATISTICS.items()}

    def check(self):
        ck = self.wl["check"]
        out = {}

        def put(errs, phase):
            for suffix, (dv, dx) in errs.items():
                out[f"dv_err{suffix}.{phase}"] = dv
                out[f"dx_err{suffix}.{phase}"] = dx

        if ck.get("sample_rows"):
            rows = inputs.sample_rows(self.n, ck["sample_rows"], self.seed,
                                      self.device)
            steps = []
            for phase, record in sorted(self.first.items()):
                full = phase == 0 and ck.get("full_start")
                errs = self._compare(record, None if full else rows)
                if phase == 0:
                    put(errs, "start")
                else:
                    steps.append(errs)
            put({suffix: tuple(max(e[suffix][k] for e in steps)
                               for k in (0, 1))
                 for suffix in steps[0]}, "steps")
        else:
            put(self._compare(self.first[0]), "start")
            put(self._compare(self.last), "last")
        if self.restart:
            out["repeat_diff"] = sum(
                compare.mismatches(a, b)
                for phase, got in self.repeats.items()
                for a, b in zip(got, self.first[phase][1]))
        if ck.get("drift"):
            c = self.config
            mass = self.s0[2]
            e0 = (rf.kinetic(self.s0[1], mass)
                  + rf.potential(self.s0[0], mass, c["softening"]))
            pos, vel = self.last[1]
            e1 = rf.kinetic(vel, mass) + rf.potential(pos, mass,
                                                      c["softening"])
            out["drift"] = compare.relative_gap(e1.item(), e0.item())
        return out
