"""Demo: gradient-based initial-condition optimization through the
simulator, on the PyTorch + CUDA port (counterpart of
examples/optimize_impact.py).

Optimizes the initial velocity of a probe body so that, after `steps` of
softened-gravity evolution inside a Plummer cluster, it arrives at a target
point: gradients flow through the whole trajectory via the analytic force
VJP (the backward kernels on the card), with the sqrt-checkpointed rollout
(sim.make_rollout_fn) so long trajectories don't store every step's
residuals. Adam (torch.optim, JAX's lr and betas) stands where the JAX demo
uses optax.

Run: python examples/torch/optimize_impact.py [--n 512] [--steps 40]
        [--iters 60] [--remat {sqrt,step,none}] [--cpu]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch

from mini_nbody_tpu_torch import SimConfig, init
from mini_nbody_tpu_torch.models.state import BodyState
from mini_nbody_tpu_torch.sim import init_carry, make_rollout_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--remat", choices=["sqrt", "step", "none"],
                    default="sqrt")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    cfg = SimConfig(n=args.n, dt=5e-3, softening=1e-2,
                    integrator="leapfrog", use_masses=True)
    gen = torch.Generator(device=device).manual_seed(0)
    cluster = init.plummer(args.n, generator=gen, device=device)
    start = torch.tensor([-1.5, -1.0, 0.0], device=device)
    target = torch.tensor([1.2, 0.8, 0.0], device=device)
    rollout = make_rollout_fn(cfg, args.steps, remat=args.remat)
    # probe = body 0 with optimizable initial velocity
    pos = torch.cat([start[None], cluster.pos[1:]])
    with torch.no_grad():
        acc0 = init_carry(cfg, BodyState(pos=pos, vel=cluster.vel,
                                         mass=cluster.mass))[1]

    def loss_fn(v0):
        vel = torch.cat([v0[None], cluster.vel[1:]])
        out, _ = rollout((BodyState(pos=pos, vel=vel, mass=cluster.mass),
                          acc0))
        return torch.sum((out.pos[0] - target) ** 2)

    # straight-line initial guess; gravity bends the path, Adam corrects it
    total_t = args.steps * cfg.dt
    v0 = ((target - start) / total_t).requires_grad_(True)
    opt = torch.optim.Adam([v0], lr=0.5, betas=(0.9, 0.999), eps=1e-8)
    for it in range(args.iters):
        opt.zero_grad()
        loss = loss_fn(v0)
        loss.backward()
        # the reported v0 is the updated one, as the JAX demo prints it
        opt.step()
        if it % 10 == 0 or it == args.iters - 1:
            print(json.dumps({
                "iter": it, "miss_distance": round(loss.item() ** 0.5, 5),
                "v0": [round(float(x), 4) for x in v0.detach()]}))


if __name__ == "__main__":
    main()
