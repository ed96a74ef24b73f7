"""Port vs JAX package: the sharded path (parallel/ on torch.distributed).

Multi-rank: gloo ranks spawned on the CPU (tests/_torch_sharded_worker.py,
which imports only the port) at world sizes 2, 3 and 4, on 1-D meshes and
the grids (1, 3), (3, 1) and (2, 2), held against JAX's simulate_sharded,
trajectory_sharded, make_sharded_step_fn(differentiable=True) and
simulate_ensemble(mesh=...) on make_mesh over as many of
tests/conftest.py's virtual CPU devices, on the same numpy inputs. Every
scenario of one world size runs in one spawn, all three spawns at once,
while the JAX side computes; the rendezvous is a file in tmp_path.

Tolerances are JAX's own (tests/test_parallel.py), on each array's scale:
- forward states and ensembles: rtol 1e-3, atol 1e-4 (its sharded forward
  tests, fp32 and sym_mxu alike: JAX's interpret mode and the port's plain
  versions both compute the bf16-class kernels in fp32);
- trajectories: rtol 1e-4, atol 1e-5 (test_trajectory_sharded_*);
- gradients: rtol 1e-4, atol 1e-5 in the fp32 class, rtol 1e-3, atol 1e-4
  in the bf16 class (test_differentiable_sharded_*).

One rank (in process, gloo on a file in tmp_path): every comm is bitwise
the single-process run on the kernel its shard runs, with the collectives
counted; and the mesh, multihost and ensemble argument checks."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mini_nbody_tpu import SimConfig as JConfig
from mini_nbody_tpu.models.state import BodyState as JState
from mini_nbody_tpu.parallel import make_mesh as jmake_mesh
from mini_nbody_tpu.parallel import simulate_sharded as jsimulate_sharded
from mini_nbody_tpu.parallel import trajectory_sharded as jtrajectory_sharded
from mini_nbody_tpu.parallel.sharded import _state_specs
from mini_nbody_tpu.parallel.sharded import make_sharded_step_fn as jstep_fn
from mini_nbody_tpu.sim import simulate_ensemble as jsimulate_ensemble
from mini_nbody_tpu_torch import (BodyState, SimConfig, make_mesh, simulate,
                                  simulate_ensemble, simulate_sharded,
                                  trajectory_ensemble, trajectory_sharded)
from mini_nbody_tpu_torch.parallel import _comm, multihost
from mini_nbody_tpu_torch.parallel.mesh import BODY_AXIS, COL_AXIS
from mini_nbody_tpu_torch.parallel.sharded import (init_sharded_carry,
                                                   make_sharded_step_fn,
                                                   shard_state)
from mini_nbody_tpu_torch.utils.config import JAX_BACKENDS

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import _torch_sharded_worker as W  # noqa: E402

torch.set_num_threads(1)

#: port backend name -> JAX's.
JAX_NAMES = {port: jx for jx, port in JAX_BACKENDS.items()}
FWD, TRAJ = (1e-3, 1e-4), (1e-4, 1e-5)
GRAD_FP32, GRAD_BF16 = (1e-4, 1e-5), (1e-3, 1e-4)
SPAWN_TIMEOUT_S = 300

CASES = [(w, name) for w in W.SCENARIOS for name in W.SCENARIOS[w]]


class _Spawns:
    """The gloo ranks of every world size, started together; results()
    waits for one world's ranks and loads their files."""

    def __init__(self, root: Path):
        self.procs, self.dirs, self.loaded = {}, {}, {}
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for world in W.SCENARIOS:
            d = root / f"world{world}"
            d.mkdir()
            self.dirs[world] = d
            self.procs[world] = [subprocess.Popen(
                [sys.executable, str(TESTS / "_torch_sharded_worker.py"),
                 str(world), str(r), str(d / "rendezvous"), str(d)],
                cwd=TESTS.parent, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self, world):
        if world not in self.loaded:
            logs = []
            for p in self.procs[world]:
                try:
                    out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    self.close()
                    raise
                logs.append(out)
            if any(p.returncode != 0 for p in self.procs[world]):
                pytest.fail(f"world {world} ranks failed:\n" + "\n".join(
                    log[-3000:] for log in logs))
            self.loaded[world] = [
                dict(np.load(self.dirs[world] / f"rank{r}.npz"))
                for r in range(world)]
        return self.loaded[world]

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    s = _Spawns(tmp_path_factory.mktemp("sharded"))
    yield s
    s.close()


def _jax_mesh(shape):
    return jmake_mesh(shape if len(shape) == 2 else shape[0])


def _jax_grad(cfg, mesh, pos, vel, mass):
    """JAX's gradient of sum(vel_final^2) in the initial positions through
    its differentiable sharded step (tests/test_parallel.py's harness)."""
    s = JState.create(pos, vel, mass)
    step = jstep_fn(cfg, mesh, differentiable=True)
    specs = _state_specs(mesh)

    def loss(pos0):
        state = JState(pos=pos0, vel=s.vel, mass=s.mass)
        state = jax.tree_util.tree_map(
            lambda x, sp: jax.lax.with_sharding_constraint(
                x, jax.sharding.NamedSharding(mesh, sp)), state, specs)
        carry = (state, jnp.zeros_like(pos0))
        for _ in range(cfg.steps):
            carry = step(carry)
        return jnp.sum(carry[0].vel ** 2)

    return np.asarray(jax.jit(jax.grad(loss))(s.pos))


def _jax_reference(sc):
    cfg = JConfig(**W.config(sc, JAX_NAMES))
    pos, vel, mass = W.inputs(sc)
    mesh = _jax_mesh(sc["mesh"])
    if sc["kind"] == "fwd":
        out = jsimulate_sharded(cfg, mesh, JState.create(pos, vel, mass))
        return {"pos": out.pos, "vel": out.vel}
    if sc["kind"] == "traj":
        out, hist = jtrajectory_sharded(cfg, mesh,
                                        JState.create(pos, vel, mass),
                                        save_every=sc["save_every"])
        return {"pos": out.pos, "hist": hist}
    if sc["kind"] == "ens":
        out = jsimulate_ensemble(cfg, JState(pos=jnp.asarray(pos),
                                             vel=jnp.asarray(vel),
                                             mass=jnp.asarray(mass)),
                                 mesh=mesh)
        return {"pos": out.pos, "vel": out.vel}
    return {"grad": _jax_grad(cfg, mesh, pos, vel, mass)}


def _tolerance(sc, field):
    if field == "grad":
        cls = SimConfig(**W.config(sc)).bf16_class()
        return GRAD_BF16 if cls else GRAD_FP32
    return TRAJ if sc["kind"] == "traj" else FWD


@pytest.mark.parametrize("world,name", CASES,
                         ids=[f"w{w}-{n}" for w, n in CASES])
def test_sharded_matches_jax(spawns, world, name):
    sc = W.SCENARIOS[world][name]
    want = _jax_reference(sc)
    got = spawns.results(world)[0]
    for field, ref in want.items():
        ref = np.asarray(ref)
        out = got[f"{name}.{field}"]
        assert out.shape == ref.shape, field
        assert np.isfinite(out).all(), field
        rtol, atol = _tolerance(sc, field)
        np.testing.assert_allclose(out, ref, rtol=rtol,
                                   atol=atol * np.abs(ref).max(),
                                   err_msg=f"{name}.{field}")


@pytest.mark.parametrize("world", list(W.SCENARIOS))
def test_every_rank_gets_the_whole_result(spawns, world):
    ranks = spawns.results(world)
    for r in range(1, world):
        assert ranks[r].keys() == ranks[0].keys()
        for k in ranks[0]:
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                          err_msg=f"rank {r} {k}")


# ---------------------------------------------------------------- one rank


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def _state(n=100, masses=True, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return BodyState.from_numpy(pos, vel, mass, device="cpu")


#: comm, backend, mesh shape, the single-process backend its shard runs,
#: and the collectives of one leapfrog step (one force pass) with masses.
ONE_RANK = [
    ("all_gather", "auto", (1,), dict(backend="direct"),
     dict(all_gather=2)),
    ("all_gather", "sym_mxu", (1,), dict(backend="mxu",
                                         pair_dtype="bfloat16"),
     dict(all_gather=2)),
    ("ring", "auto", (1,), dict(backend="sym"), {}),
    ("ring_sym", "auto", (1,), dict(backend="sym"), {}),
    ("grid", "direct", (1, 1), dict(backend="direct"),
     dict(all_gather=3, reduce_scatter=1)),
]


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("comm,backend,shape,single,calls", ONE_RANK,
                         ids=[f"{c}-{b}" for c, b, *_ in ONE_RANK])
def test_one_rank_is_bitwise_the_single_process_run(one_rank, comm, backend,
                                                    shape, single, calls,
                                                    masses):
    n = 100
    state = _state(n, masses)
    cfg = SimConfig(n=n, dt=1e-3, steps=3, softening=1e-2,
                    integrator="leapfrog", use_masses=masses,
                    backend=backend, comm=comm, mesh_shape=shape)
    mesh = make_mesh(shape)
    for k in _comm.CALLS:
        _comm.CALLS[k] = 0
    out = simulate_sharded(cfg, mesh, state)
    ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather", **single),
                   state)
    assert torch.equal(out.pos, ref.pos) and torch.equal(out.vel, ref.vel)
    # 4 force passes (the initial acceleration and 3 steps); masses travel
    # only in mass mode; the final state is gathered once.
    want = {k: 4 * v for k, v in calls.items()}
    if not masses:
        want = {k: v - 4 * (k == "all_gather") for k, v in want.items()}
    want["all_gather"] = want.get("all_gather", 0) + 1
    assert _comm.CALLS == dict(dict.fromkeys(_comm.CALLS, 0), **want)


@pytest.mark.parametrize("comm", ["ring", "ring_sym"])
def test_one_rank_self_hop_ignores_traversal(one_rank, comm):
    # JAX's sharded self kernels never take cfg.traversal
    # (mini_nbody_tpu/parallel/sharded.py:147-149, :214-219), so they run
    # the slots; the port's do too: traversal='band' is bitwise 'slots'.
    n = 300
    state = _state(n)
    cfg = SimConfig(n=n, dt=1e-3, steps=2, softening=1e-2,
                    integrator="leapfrog", use_masses=True,
                    backend="sym_mxu", sym_tile=64, comm=comm,
                    mesh_shape=(1,))
    mesh = make_mesh((1,))
    band = simulate_sharded(cfg.replace(traversal="band"), mesh, state)
    slots = simulate_sharded(cfg.replace(traversal="slots"), mesh, state)
    assert torch.equal(band.pos, slots.pos)
    assert torch.equal(band.vel, slots.vel)
    ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather"), state)
    assert torch.equal(slots.pos, ref.pos)


def test_one_rank_mesh_and_carry(one_rank):
    mesh = make_mesh()
    assert (mesh.shape, mesh.coords, mesh.index, mesh.size) == ((1,), (0,),
                                                               0, 1)
    assert mesh.axis_names == (BODY_AXIS,)
    grid = make_mesh((1, 1))
    assert grid.axis_names == (BODY_AXIS, COL_AXIS)
    assert grid.axis_index(COL_AXIS) == 0 and grid.device.type == "cpu"
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((2,))
    with pytest.raises(ValueError, match="1-D or 2-D"):
        make_mesh((1, 1, 1))
    cfg = SimConfig(n=10, comm="grid")
    with pytest.raises(ValueError, match="2-D mesh"):
        make_sharded_step_fn(cfg, mesh)
    with pytest.raises(ValueError, match="1-D mesh"):
        make_sharded_step_fn(cfg.replace(comm="ring"), grid)
    with pytest.raises(TypeError, match="Mesh"):
        make_sharded_step_fn(cfg, object())
    state = _state(10)
    local = shard_state(state, mesh)
    carry = init_sharded_carry(cfg.replace(comm="ring",
                                           integrator="leapfrog"), mesh,
                               local)
    assert carry[1].shape == (10, 3) and carry[1].abs().max() > 0


def test_one_rank_trajectory_and_ensemble(one_rank):
    mesh = make_mesh(1)
    state = _state(50)
    cfg = SimConfig(n=50, dt=1e-3, softening=1e-2, integrator="leapfrog",
                    use_masses=True, comm="ring_sym", mesh_shape=(1,))
    final, hist = trajectory_sharded(cfg, mesh, state, steps=4, save_every=2)
    ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather",
                               backend="sym"), state, steps=4)
    assert hist.shape == (2, 50, 3)
    assert torch.equal(final.pos, ref.pos) and torch.equal(hist[-1], ref.pos)
    with pytest.raises(ValueError, match="divisible"):
        trajectory_sharded(cfg, mesh, state, steps=5, save_every=2)
    rng = np.random.default_rng(5)
    ens = BodyState.from_numpy(
        rng.uniform(-1, 1, (3, 40, 3)), 0.1 * rng.normal(size=(3, 40, 3)),
        rng.uniform(0.5, 2.0, (3, 40)), device="cpu")
    ecfg = SimConfig(n=40, steps=3, dt=1e-3, softening=1e-2, backend="sym",
                     use_masses=True, integrator="leapfrog")
    got = simulate_ensemble(ecfg, ens, mesh=mesh)
    want = simulate_ensemble(ecfg, ens)
    assert torch.equal(got.pos, want.pos) and torch.equal(got.vel, want.vel)
    got_final, got_hist = trajectory_ensemble(ecfg, ens, save_every=1,
                                              mesh=mesh)
    want_final, want_hist = trajectory_ensemble(ecfg, ens, save_every=1)
    assert torch.equal(got_hist, want_hist)
    assert torch.equal(got_final.pos, want_final.pos)


def test_multihost_initialize(monkeypatch):
    for k in multihost._ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert multihost.initialize() is False and multihost.is_primary()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     WORLD_SIZE="1", RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    if not torch.cuda.is_available():
        # A card is the default: without one NCCL's device is refused, and
        # gloo is never taken in its place.
        with pytest.raises(RuntimeError, match="no card"):
            multihost.initialize()
        assert not dist.is_initialized()
    with pytest.raises(ValueError, match="device"):
        multihost.initialize(device="tpu")
    try:
        assert multihost.initialize(device="cpu") is True
        assert dist.get_backend() == "gloo" and multihost.is_primary()
        assert multihost.global_mesh().shape == (1,)
    finally:
        dist.destroy_process_group()
