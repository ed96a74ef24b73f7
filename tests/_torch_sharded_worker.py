"""One gloo rank of the port's sharded path on the CPU, for
tests/test_torch_sharded.py. Imports torch, numpy and the port only.

    python tests/_torch_sharded_worker.py WORLD RANK RENDEZVOUS_FILE OUT_DIR

joins a WORLD-rank gloo group through ``file://RENDEZVOUS_FILE``, runs every
scenario of SCENARIOS[WORLD] and writes each rank's results to
OUT_DIR/rank{RANK}.npz: every rank gets the whole result, so the test holds
rank 0's against JAX and every other rank's against rank 0's.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

#: Scenarios per world size: name -> dict(kind, comm, backend (the port's
#: name), mesh, n, masses, integrator, steps, softening[, b, save_every]).
#: kind: "fwd" (simulate_sharded), "diff" (the gradient of sum(vel_final^2)
#: in the initial positions through make_sharded_step_fn(differentiable=
#: True)), "traj" (trajectory_sharded) or "ens" (simulate_ensemble with a
#: mesh). N = 101 and 100 do not divide every mesh (padding); the
#: gradients take N = 96, which every mesh divides, as JAX's sharding
#: constraint needs.
_FWD = dict(kind="fwd", integrator="leapfrog", steps=3, softening=1e-2,
            n=101, masses=True)
_DIFF = dict(kind="diff", integrator="euler", steps=3, softening=1e-2, n=96,
             masses=True)
SCENARIOS = {
    2: {
        "all_gather_auto_unit": dict(_FWD, comm="all_gather", backend="auto",
                                     mesh=(2,), masses=False,
                                     integrator="euler", softening=1e-9),
        "ring_auto": dict(_FWD, comm="ring", backend="auto", mesh=(2,)),
        "ring_sym_sym": dict(_FWD, comm="ring_sym", backend="sym",
                             mesh=(2,)),
        "ring_sym_sym_mxu": dict(_FWD, comm="ring_sym", backend="sym_mxu",
                                 mesh=(2,), steps=2),
        "diff_all_gather": dict(_DIFF, comm="all_gather", backend="auto",
                                mesh=(2,)),
        "diff_ring": dict(_DIFF, comm="ring", backend="auto", mesh=(2,),
                          masses=False),
        "traj_ring_sym": dict(_FWD, kind="traj", comm="ring_sym",
                              backend="sym", mesh=(2,), steps=4,
                              save_every=2),
        "ensemble_sym": dict(kind="ens", backend="sym", mesh=(2,), b=4, n=64,
                             masses=True, integrator="leapfrog", steps=3,
                             softening=1e-2),
    },
    3: {
        "ring_sym_sym_unit": dict(_FWD, comm="ring_sym", backend="sym",
                                  mesh=(3,), n=100, masses=False),
        "ring_sym_sym_mxu": dict(_FWD, comm="ring_sym", backend="sym_mxu",
                                 mesh=(3,), steps=2),
        "all_gather_sym_mxu": dict(_FWD, comm="all_gather",
                                   backend="sym_mxu", mesh=(3,)),
        "grid_1x3": dict(_FWD, comm="grid", backend="auto", mesh=(1, 3)),
        "grid_3x1": dict(_FWD, comm="grid", backend="direct", mesh=(3, 1),
                         n=100, masses=False),
        "diff_grid_1x3": dict(_DIFF, comm="grid", backend="auto",
                              mesh=(1, 3)),
        "diff_grid_3x1": dict(_DIFF, comm="grid", backend="auto",
                              mesh=(3, 1)),
        "diff_ring_sym": dict(_DIFF, comm="ring_sym", backend="sym",
                              mesh=(3,)),
        "ensemble_sym_mxu": dict(kind="ens", backend="sym_mxu", mesh=(3,),
                                 b=6, n=64, masses=True,
                                 integrator="leapfrog", steps=3,
                                 softening=1e-2),
    },
    4: {
        "ring_sym_sym": dict(_FWD, comm="ring_sym", backend="sym",
                             mesh=(4,)),
        "ring_backend_sym_mxu": dict(_FWD, comm="ring", backend="sym_mxu",
                                     mesh=(4,)),
        "grid_2x2": dict(_FWD, comm="grid", backend="direct", mesh=(2, 2)),
        "grid_2x2_sym_mxu": dict(_FWD, comm="grid", backend="sym_mxu",
                                 mesh=(2, 2)),
        "diff_grid_2x2": dict(_DIFF, comm="grid", backend="auto",
                              mesh=(2, 2)),
        "diff_grid_2x2_unit": dict(_DIFF, comm="grid", backend="auto",
                                   mesh=(2, 2), masses=False),
        "diff_grid_2x2_sym_mxu": dict(_DIFF, comm="grid", backend="sym_mxu",
                                      mesh=(2, 2)),
        "diff_ring_sym_mxu": dict(_DIFF, comm="ring", backend="sym_mxu",
                                  mesh=(4,)),
        "diff_all_gather_sym_mxu": dict(_DIFF, comm="all_gather",
                                        backend="sym_mxu", mesh=(4,),
                                        masses=False),
        "traj_all_gather": dict(_FWD, kind="traj", comm="all_gather",
                                backend="auto", mesh=(4,), steps=4,
                                save_every=2),
        "ensemble_sym": dict(kind="ens", backend="sym", mesh=(4,), b=8, n=64,
                             masses=False, integrator="euler", steps=3,
                             softening=1e-2),
    },
}


def inputs(sc: dict, seed: int = 0):
    """pos, vel (n, 3) or (b, n, 3) and masses (n,) or (b, n), float32;
    unit masses when sc["masses"] is False."""
    shape = (sc["b"], sc["n"]) if sc["kind"] == "ens" else (sc["n"],)
    rng = np.random.default_rng(seed + sc["n"])
    pos = rng.uniform(-1, 1, (*shape, 3)).astype(np.float32)
    vel = (0.1 * rng.normal(size=(*shape, 3))).astype(np.float32)
    mass = (rng.uniform(0.5, 2.0, shape) if sc["masses"]
            else np.ones(shape)).astype(np.float32)
    return pos, vel, mass


def config(sc: dict, jax_backends: dict | None = None) -> dict:
    """The SimConfig fields of a scenario; with jax_backends (port name ->
    JAX name) the JAX package's."""
    backend = sc["backend"]
    if jax_backends is not None:
        backend = jax_backends[backend]
    kw = dict(n=sc["n"], dt=1e-3, steps=sc["steps"], backend=backend,
              softening=sc["softening"], integrator=sc["integrator"],
              use_masses=sc["masses"], tile_i=32, tile_j=128)
    if sc["kind"] != "ens":
        kw.update(comm=sc["comm"], mesh_shape=sc["mesh"])
    return kw


def run(world: int, rank: int, rdv: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from mini_nbody_tpu_torch import (BodyState, SimConfig, make_mesh,
                                      simulate_ensemble, simulate_sharded,
                                      trajectory_sharded)
    from mini_nbody_tpu_torch.parallel.sharded import (make_sharded_step_fn,
                                                       shard_state)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    meshes = {}
    results = {}
    for name, sc in SCENARIOS[world].items():
        if sc["mesh"] not in meshes:  # every rank builds them in one order
            meshes[sc["mesh"]] = make_mesh(sc["mesh"])
        mesh = meshes[sc["mesh"]]
        cfg = SimConfig(**config(sc))
        state = BodyState.from_numpy(*inputs(sc), device="cpu")
        if sc["kind"] == "fwd":
            out = simulate_sharded(cfg, mesh, state)
            results.update({f"{name}.pos": out.pos, f"{name}.vel": out.vel})
        elif sc["kind"] == "traj":
            out, hist = trajectory_sharded(cfg, mesh, state,
                                           save_every=sc["save_every"])
            results.update({f"{name}.pos": out.pos, f"{name}.hist": hist})
        elif sc["kind"] == "ens":
            out = simulate_ensemble(cfg, state, mesh=mesh)
            results.update({f"{name}.pos": out.pos, f"{name}.vel": out.vel})
        else:
            local = shard_state(state, mesh, pad_far=not cfg.use_masses)
            p0 = local.pos.clone().requires_grad_(True)
            step = make_sharded_step_fn(cfg, mesh, differentiable=True)
            carry = (BodyState(p0, local.vel, local.mass),
                     torch.zeros_like(p0))
            for _ in range(cfg.steps):
                carry = step(carry)
            (carry[0].vel ** 2).sum().backward()
            grad = torch.empty((mesh.size * p0.shape[0], 3))
            dist.all_gather_into_tensor(grad, p0.grad)
            results[f"{name}.grad"] = grad[:sc["n"]]
    dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz",
             **{k: v.detach().numpy() for k, v in results.items()})


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
