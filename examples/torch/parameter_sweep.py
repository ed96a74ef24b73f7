"""Demo: batched parameter sweep, B perturbed systems in one run, on the
PyTorch + CUDA port (counterpart of examples/parameter_sweep.py).

Run: python examples/torch/parameter_sweep.py [--b 32] [--n 1024]
                                              [--steps 200] [--cpu]

B copies of a Plummer sphere, each with a different velocity-scale factor
q (the virial knob: q=1 is equilibrium, q<1 collapses, q>1 expands),
integrated together by sim.simulate_ensemble: every launch of the ensemble
kernels takes all B systems (or the resident kernel takes the whole
trajectory). Per-system energy drift and the half-mass radius trend are
reported per system; the wall time is that of one batched trajectory, and
the rate is printed beside the device's name.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch

from mini_nbody_tpu_torch import SimConfig, init
from mini_nbody_tpu_torch.models.state import BodyState
from mini_nbody_tpu_torch.ops import diagnostics as diag
from mini_nbody_tpu_torch.sim import simulate_ensemble


def half_mass_radius(pos, mass):
    """Median radius from the center of mass, per system (B, N, 3)."""
    com = (pos * mass[..., None]).sum(1) / mass.sum(1, keepdim=True)
    return (pos - com[:, None, :]).norm(dim=-1).median(dim=1).values


def device_name(device):
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    soft = 1e-3
    cfg = SimConfig(n=args.n, dt=args.dt, steps=args.steps, softening=soft,
                    integrator="leapfrog", use_masses=True,
                    backend="sym_mxu")
    gen = torch.Generator(device=device).manual_seed(0)
    base = init.plummer(args.n, generator=gen, device=device)
    b, n = args.b, args.n
    q = torch.linspace(0.2, 1.6, b, device=device)  # velocity-scale sweep
    st = BodyState(pos=base.pos.expand(b, n, 3).contiguous(),
                   vel=(base.vel[None] * q[:, None, None]).contiguous(),
                   mass=base.mass.expand(b, n).contiguous())

    e0 = diag.total_energy_ensemble(st, soft)
    r0 = half_mass_radius(st.pos, st.mass)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = simulate_ensemble(cfg, st)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    e1 = diag.total_energy_ensemble(out, soft)
    r1 = half_mass_radius(out.pos, out.mass)

    drift = ((e1 - e0) / e0).abs()
    print(json.dumps({
        "B": b, "n": n, "steps": args.steps,
        "backend": cfg.effective_backend(),
        "device": device_name(device),
        "wall_s": round(wall, 3),
        "pairs_per_s": round(b * args.steps * n ** 2 / 2 / wall / 1e9, 2),
        "max_energy_drift": float(drift.max()),
    }))
    for i in range(b):
        print(json.dumps({
            "q": round(float(q[i]), 3),
            "energy_drift": float(drift[i]),
            "r_half": round(float(r1[i]), 4),
            "r_half_ratio": round(float(r1[i] / r0[i]), 3),
        }))

    # Sanity: collapsing (q<<1) systems shrink, hot (q>1.4) ones expand.
    rr = r1 / r0
    if not (rr[q < 0.5].mean() < 1.0 and rr[q > 1.4].mean() > 1.0):
        raise SystemExit("cold systems should contract and hot ones expand")
    print(json.dumps({"sweep_trend": "ok"}))


if __name__ == "__main__":
    main()
