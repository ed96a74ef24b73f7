"""Entry points: one step on the card, and a multi-rank dry run.

Counterpart of ``__graft_entry__.py:7-155``. ``entry()`` returns a step
function and its example arguments at N = 16,384 on backend ``auto``;
``dryrun_multichip(n_ranks)`` starts n_ranks gloo ranks on the CPU (a
``file://`` rendezvous in a temporary directory) and runs, in each, JAX's
loop of sharded steps on tiny shapes, raising if any rank fails.

    python -m mini_nbody_tpu_torch.entry            # one step on the card
    python -m mini_nbody_tpu_torch.entry --ranks 4  # the dry run
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

#: Seconds each rank of dryrun_multichip may take.
RANK_TIMEOUT_S = 240


def entry(device="cuda"):
    """(step, example_args): one semi-implicit Euler step (the reference
    mini-nbody semantics) at N = 16,384 on backend 'auto' (K3 on the
    card), from uniform bodies of seed 0 on ``device``."""
    from mini_nbody_tpu_torch import SimConfig, init
    from mini_nbody_tpu_torch.sim import make_step_fn

    n = 16384
    cfg = SimConfig(n=n, dt=0.01, backend="auto")
    gen = torch.Generator(device=device).manual_seed(0)
    state = init.uniform_random(n, generator=gen, device=device)
    acc = torch.zeros_like(state.pos)
    return make_step_fn(cfg), ((state, acc),)


def _rank(rank: int, world: int, rdv: str) -> None:
    """One gloo rank of the dry run: JAX's cases on tiny shapes, each
    result's shape and finiteness checked."""
    import dataclasses

    import torch.distributed as dist

    from mini_nbody_tpu_torch import SimConfig, init, make_mesh
    from mini_nbody_tpu_torch.models.state import BodyState
    from mini_nbody_tpu_torch.parallel.sharded import (init_sharded_carry,
                                                       make_sharded_step_fn,
                                                       shard_state)
    from mini_nbody_tpu_torch.sim import simulate_ensemble

    def check(t, shape, what):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise RuntimeError(f"rank {rank}: {what}: shape "
                               f"{tuple(t.shape)}, want {shape}, or not "
                               "finite")

    def state_of(n, seed):
        gen = torch.Generator().manual_seed(seed)
        return init.uniform_random(n, generator=gen, device="cpu")

    def grad(step, st):
        p = st.pos.clone().requires_grad_(True)
        out, _ = step((dataclasses.replace(st, pos=p),
                       torch.zeros_like(p)))
        (out.pos ** 2).sum().backward()
        return p.grad

    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        n = 16 * world
        mesh = make_mesh(world)
        cfg = SimConfig(n=n, dt=0.01, steps=1, integrator="leapfrog",
                        backend="torch", comm="ring")
        state = shard_state(state_of(n, 0), mesh)
        carry = init_sharded_carry(cfg, mesh, state)
        out, _ = make_sharded_step_fn(cfg, mesh)(carry)
        check(out.pos, (16, 3), "ring on torch")
        # The all_gather and half-ring exchanges, the half ring on the
        # sym_mxu pair kernels' plain versions, with and without masses.
        for comm, be, masses in (("all_gather", "torch", False),
                                 ("ring_sym", "torch", False),
                                 ("ring_sym", "sym_mxu", False),
                                 ("ring_sym", "sym_mxu", True)):
            cfg2 = cfg.replace(comm=comm, integrator="euler", backend=be,
                               use_masses=masses)
            out2, _ = make_sharded_step_fn(cfg2, mesh)(carry)
            check(out2.pos, (16, 3), f"{comm} on {be}")
        # A mesh-sharded ensemble: one tiny system per rank.
        ne = 16
        systems = [state_of(ne, 100 + i) for i in range(world)]
        batched = BodyState(*(torch.stack([getattr(s, f) for s in systems])
                              for f in ("pos", "vel", "mass")))
        cfg_e = SimConfig(n=ne, dt=0.01, steps=1, backend="sym_mxu")
        out_e = simulate_ensemble(cfg_e, batched, mesh=mesh)
        check(out_e.pos, (world, ne, 3), "ensemble")
        # The differentiable ring step on the bf16 class.
        cfg_d = cfg.replace(integrator="euler", backend="sym_mxu")
        g = grad(make_sharded_step_fn(cfg_d, mesh, differentiable=True), out)
        check(g, (16, 3), "ring gradient")
        if world >= 4:
            # The 2-D grid, forward and differentiable: (2, P / 2), or
            # (1, P) for an odd P (a port mesh spans every rank).
            shape = (2, world // 2) if world % 2 == 0 else (1, world)
            n3 = 16 * world
            cfg3 = SimConfig(n=n3, dt=0.01, steps=1, backend="torch",
                             comm="grid", mesh_shape=shape)
            mesh2 = make_mesh(shape)
            state3 = shard_state(state_of(n3, 1), mesh2)
            carry3 = init_sharded_carry(cfg3, mesh2, state3)
            out3, _ = make_sharded_step_fn(cfg3, mesh2)(carry3)
            check(out3.pos, (16, 3), "grid")
            g3 = grad(make_sharded_step_fn(cfg3, mesh2, differentiable=True),
                      out3)
            check(g3, (16, 3), "grid gradient")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int) -> None:
    """Run _rank on n_ranks gloo ranks of this machine's CPU, one process
    each; raises RuntimeError naming the ranks that failed."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory() as d:
        logs = [open(Path(d) / f"rank{r}.log", "w+") for r in range(n_ranks)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mini_nbody_tpu_torch.entry", "--rank",
             str(r), "--ranks", str(n_ranks), "--rdv", f"{d}/rdv"],
            env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(logs)]
        try:
            for p in procs:
                p.wait(timeout=RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            failed = []
            for r, (p, log) in enumerate(zip(procs, logs)):
                log.seek(0)
                if p.returncode:
                    failed.append((r, p.returncode, log.read()[-2000:]))
                log.close()
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_ranks}): ranks failed: "
                           f"{failed}")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="run dryrun_multichip over this many gloo ranks")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rdv", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args.rank, args.ranks, args.rdv)
    elif args.ranks:
        dryrun_multichip(args.ranks)
        print(f"dryrun_multichip({args.ranks}) OK")
    else:
        step, (carry,) = entry()
        out, _ = step(carry)
        torch.cuda.synchronize()
        print("entry() step OK:", tuple(out.pos.shape))


if __name__ == "__main__":
    main()
