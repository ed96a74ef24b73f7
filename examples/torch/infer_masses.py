"""Demo: infer per-body masses from an observed trajectory, on the PyTorch
+ CUDA port (counterpart of examples/infer_masses.py).

Generates a short "observed" trajectory with hidden true masses, then
recovers them by gradient descent on the trajectory mismatch: gradients
flow to the masses through every step via the analytic mass cotangent
(dF_j/dm_k = w d_jk; ops/autodiff.make_differentiable_force(mass_grad=True),
the pair-once backward kernel on the card). Adam (torch.optim, JAX's lr
and betas) stands where the JAX demo uses optax.

Run: python examples/torch/infer_masses.py [--n 64] [--steps 30]
                                           [--iters 200] [--cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch

from mini_nbody_tpu_torch import SimConfig, init
from mini_nbody_tpu_torch.models.state import BodyState
from mini_nbody_tpu_torch.ops.autodiff import make_differentiable_force
from mini_nbody_tpu_torch.ops.integrators import leapfrog_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    cfg = SimConfig(n=args.n, dt=2e-2, softening=1e-2,
                    integrator="leapfrog", use_masses=True)
    gen = torch.Generator(device=device).manual_seed(0)
    s0 = init.plummer(args.n, generator=gen, device=device)
    true_mass = s0.mass * (0.5 + 1.5 * torch.rand(
        args.n, generator=gen, device=device))

    force = make_differentiable_force(cfg, mass_grad=True)

    def f3(pos_i, pos_j, mass_j):
        return force(pos_i, mass_j)

    def rollout(mass):
        state = BodyState(pos=s0.pos, vel=s0.vel, mass=mass)
        acc = f3(s0.pos, s0.pos, mass)
        snaps = []
        for _ in range(args.steps):
            state, acc = leapfrog_step(state, acc, f3, cfg.dt)
            snaps.append(state.pos)
        # velocities carry most of the mass signal over short horizons
        return torch.stack(snaps), state.vel

    with torch.no_grad():
        obs_pos, obs_vel = rollout(true_mass)

    def loss(log_mass):
        # optimize in log space: masses stay positive
        pos, vel = rollout(torch.exp(log_mass))
        return (torch.mean((pos - obs_pos) ** 2)
                + torch.mean((vel - obs_vel) ** 2))

    params = torch.full((args.n,), float(true_mass.mean()), device=device)
    params = params.log().requires_grad_(True)
    opt = torch.optim.Adam([params], lr=1e-1, betas=(0.9, 0.999), eps=1e-8)

    def median_err():
        with torch.no_grad():
            return float(((params.exp() - true_mass).abs()
                          / true_mass).median())

    for it in range(args.iters):
        opt.zero_grad()
        val = loss(params)
        val.backward()
        opt.step()
        if it % 20 == 0 or it == args.iters - 1:
            print(f"iter {it:4d}  loss {val.item():.3e}  "
                  f"median mass err {median_err():.3e}")

    err = median_err()
    print(f"final median relative mass error: {err:.3e}")
    if not err < 0.05:
        raise SystemExit("mass inference did not converge")
    print("OK")


if __name__ == "__main__":
    main()
