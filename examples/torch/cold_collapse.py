"""Demo: cold-sphere gravitational collapse with live diagnostics, on the
PyTorch + CUDA port (counterpart of examples/cold_collapse.py).

Run: python examples/torch/cold_collapse.py [--n 8192] [--steps 400] [--cpu]

A uniform cold (zero-velocity) sphere collapses under self-gravity, bounces
at ~a free-fall time, and relaxes. Total energy is conserved by the leapfrog
integrator; the virial ratio -2T/U swings through the collapse. Prints one
JSON metrics row per interval (utils.tracing.StepMetrics).
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch

from mini_nbody_tpu_torch import SimConfig, init
from mini_nbody_tpu_torch.ops import diagnostics as diag
from mini_nbody_tpu_torch.sim import init_carry, make_step_fn
from mini_nbody_tpu_torch.utils.tracing import StepMetrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--interval", type=int, default=50)
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    soft = 1e-3
    cfg = SimConfig(n=args.n, dt=args.dt, steps=args.steps, softening=soft,
                    integrator="leapfrog", use_masses=True)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init.cold_sphere(args.n, generator=gen, device=device)
    e0 = float(diag.total_energy(state, soft))
    print(json.dumps({"n": args.n, "e0": e0,
                      "backend": cfg.effective_backend()}))

    step = make_step_fn(cfg)
    with torch.no_grad():
        carry = init_carry(cfg, state)
        metrics = StepMetrics(n=args.n).start()
        for _ in range(args.steps // args.interval):
            for _ in range(args.interval):
                carry = step(carry)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            st = carry[0]
            ke = float(diag.kinetic_energy(st.vel, st.mass))
            e = float(diag.total_energy(st, soft))
            row = metrics.tick(
                args.interval,
                energy=round(e, 6),
                drift=round(abs(e - e0) / abs(e0), 8),
                virial=round(-2 * ke / (e - ke), 3) if e != ke else None,
            )
            print(json.dumps(row))


if __name__ == "__main__":
    main()
