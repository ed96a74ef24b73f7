"""One gloo rank of the port's sharded path on the CPU, for
tests/test_torch_sharded.py. Imports torch, numpy and the port only.

    python tests/_torch_sharded_worker.py WORLD RANK RENDEZVOUS_FILE OUT_DIR

joins a WORLD-rank gloo group through ``file://RENDEZVOUS_FILE``, runs every
scenario of SCENARIOS[WORLD] and writes each rank's results to
OUT_DIR/rank{RANK}.npz: every rank gets the whole result, so the test holds
rank 0's against JAX and every other rank's against rank 0's. At world size
4 the ranks then run the "mesh" mode: MESH's runs of BASELINE config 4's
exchange, with the collectives they counted and the ``nbody.comm`` spans
they opened, which the test holds to a float64 reference of its own.
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


#: The "mesh" mode (world size 4): config 4's deployment on the CPU, the
#: bodies sharded over 4 ranks with one position all-gather a step (comm
#: 'all_gather' on 'auto', the ordered direct kernel under sharding),
#: mini-nbody's physics (randomizeBodies, unit masses, softening 1e-9, dt
#: 0.01, Euler). N = 509 pads to 512 with FAR bodies.
MESH = {"n512": 512, "n509": 509}
MESH_WORLD, MESH_STEPS = 4, 3
#: The registry's counters a mesh run reports, each ``comm.<name>``.
MESH_COUNTERS = ("all_gather", "reduce_scatter", "ppermute", "bytes")


def mesh_inputs(n: int):
    """randomizeBodies: positions and velocities uniform in [-1, 1], unit
    masses, float32."""
    rng = np.random.default_rng(n)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return pos, vel, np.ones(n, np.float32)


def mesh_config(n: int) -> dict:
    return dict(n=n, dt=0.01, steps=MESH_STEPS, backend="auto",
                softening=1e-9, integrator="euler", use_masses=False,
                comm="all_gather", mesh_shape=(MESH_WORLD,))


def run_mesh(mesh) -> dict:
    """Each MESH run three times: once for its state and the collectives it
    counted, once under a CPU profiler for its ``nbody.comm`` spans and the
    collectives beside them, and once with no profiler recording, in which
    no span may enter ``record_function``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mini_nbody_tpu_torch import BodyState, SimConfig, simulate_sharded
    from mini_nbody_tpu_torch.utils import tracing

    def moved(before):
        now = tracing.counters() - before
        return np.array([now[f"comm.{k}"] for k in MESH_COUNTERS])

    out = {}
    for name, n in MESH.items():
        cfg = SimConfig(**mesh_config(n))
        state = BodyState.from_numpy(*mesh_inputs(n), device="cpu")
        before = tracing.counters()
        got = simulate_sharded(cfg, mesh, state)
        out[f"mesh.{name}.counts"] = moved(before)
        out[f"mesh.{name}.pos"], out[f"mesh.{name}.vel"] = got.pos, got.vel
        before = tracing.counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            simulate_sharded(cfg, mesh, state)
        out[f"mesh.{name}.profiled_counts"] = moved(before)
        out[f"mesh.{name}.profiled_spans"] = np.array(
            sum(e.name == "nbody.comm" for e in prof.events()))
        entered = []
        real = tracing.record_function
        tracing.record_function = lambda span: entered.append(span) or real(
            span)
        try:
            simulate_sharded(cfg, mesh, state)
        finally:
            tracing.record_function = real
        out[f"mesh.{name}.unprofiled_spans"] = np.array(len(entered))
    return {k: torch.as_tensor(v) for k, v in out.items()}


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
    if world == MESH_WORLD:
        results.update(run_mesh(make_mesh((MESH_WORLD,))))
    dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz",
             **{k: v.detach().numpy() for k, v in results.items()})


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
