"""The cell config 4 across cards: its check at a size a CPU test can hold,
its ranks and its failure modes, and the readers of its per-layer metrics
on traces made up here.

``mininbody-fp32-mesh4.n1m-euler`` runs here as 4 gloo ranks on the CPU
(``sharded_trajectory`` with ``device="cpu"``): rank 0 in this process,
ranks 1-3 spawned. A fault on rank 0 breaks its view of each call after the
sharded call has run on every rank, so the ranks stay in step: the call's
state returned unchanged, one rank's block left as it came in, one tile of
the answers altered (the cell holds percentiles, no worst body). A fault on
another rank runs in that rank's process (the traffic spawns the function
patched in for its ``_rank``): rank 1 starts a chained call from the
seed's bodies, rank 2 keeps a wrong copy of the gathered state.
"""

import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from portbench import mesh, profiling, run, work
from portbench.traffic import sharded_trajectory
from test_portbench_checks import failed, limits
from test_portbench_spans import read_metric

MESH = "mininbody-fp32-mesh4.n1m-euler"
SEED = 2**31 + 977
#: Seconds a rank's collective waits here before it gives up.
TIMEOUT_S = 20

SMALL = {
    # at 512 bodies the control (B6's plain version, the identity form in
    # fp32) stays under the full size's limits: 4 seeds, 4 ranks, read the
    # 99th and 99.9th percentiles at the start 2.6e-7-2.1e-6 (program)
    # against 1.2e-5-1.8e-4 (control)
    MESH: {"n": 512,
           "check": {"sample_rows": 64, "full_start": True},
           "limits": limits(MESH, **{
               k: 6e-6 for k in ("dv_err.p99.start", "dx_err.p99.start",
                                 "dv_err.p999.start",
                                 "dx_err.p999.start")})},
}


@pytest.fixture(autouse=True)
def short_timeout(monkeypatch):
    monkeypatch.setattr(sharded_trajectory, "TIMEOUT_S", TIMEOUT_S)


def run_small(cell, control=False, hook=None, seconds=0.3):
    return run.run_cell(cell, SEED, seconds, False, device="cpu",
                        control=control, workload_overrides=SMALL[cell],
                        driver_hook=hook)


def test_the_program_passes():
    result = run_small(MESH)
    assert result["correct"], result["checks"]
    assert result["checks"]["rank_diff"]["value"] == 0


def test_the_control_fails():
    result = run_small(MESH, control=True)
    assert not result["correct"], result["checks"]


# Faults of the mesh cell: rank 0's copy of the gathered state after a
# call that every rank made.

def mesh_unchanged(driver):
    run_ = driver.run

    def one(pos, vel, mass):
        run_(pos, vel, mass)
        return pos.clone(), vel.clone()
    driver.run = one


def mesh_block_left_out(driver):
    run_ = driver.run

    def one(pos, vel, mass):
        p, v = run_(pos, vel, mass)
        p, v = p.clone(), v.clone()
        rows = slice(p.shape[0] - p.shape[0] // driver.ranks, None)
        p[rows], v[rows] = pos[rows], vel[rows]
        return p, v
    driver.run = one


def mesh_altered(driver):
    # the cell compares percentiles of the bodies and no worst body (K1
    # sums a body's 2^20 terms in order in fp32, PERF.md section 4), so as
    # in test_portbench_checks.altered one tile of the bodies' velocities,
    # 1/32 of them, is altered
    run_ = driver.run

    def one(pos, vel, mass):
        p, v = run_(pos, vel, mass)
        v = v.clone()
        n = v.shape[0]
        v[n // 4:n // 4 + n // 32] *= 1.01
        return p, v
    driver.run = one


@pytest.mark.parametrize("fault", [mesh_unchanged, mesh_block_left_out,
                                   mesh_altered], ids=lambda f: f.__name__)
def test_a_fault_fails_the_mesh(fault):
    result = run_small(MESH, hook=fault)
    assert not result["correct"], result["checks"]
    assert failed(result)


# Faults of the other ranks, in their own processes.

def rank_1_restarts_from_the_seed(rank, *args):
    if rank == 1:
        sharded_trajectory._inputs = lambda cmd, s0, cur: s0[:2]
    sharded_trajectory._rank(rank, *args)


def rank_2_gathers_a_block_wrong(rank, *args):
    if rank == 2:
        make = sharded_trajectory._sharded_run

        def wrong(*a):
            run_ = make(*a)

            def one(pos, vel, mass):
                p, v = run_(pos, vel, mass)
                v = v.clone()
                v[:v.shape[0] // 4] = vel[:v.shape[0] // 4]
                return p, v
            return one
        sharded_trajectory._sharded_run = wrong
    sharded_trajectory._rank(rank, *args)


@pytest.mark.parametrize("fault", [rank_1_restarts_from_the_seed,
                                   rank_2_gathers_a_block_wrong],
                         ids=lambda f: f.__name__)
def test_a_fault_on_another_rank_fails_the_mesh(fault, monkeypatch):
    monkeypatch.setattr(sharded_trajectory, "_rank", fault)
    result = run_small(MESH)
    assert failed(result) == ["rank_diff"], result["checks"]
    assert result["checks"]["rank_diff"]["value"] > 0


def test_the_mesh_runs_on_four_ranks():
    seen = {}

    def hook(driver):
        seen["ranks"] = driver.ranks
        seen["procs"] = len(driver.procs)
        seen["mesh"] = driver.mesh.shape
    result = run_small(MESH, hook=hook)
    assert seen == {"ranks": 4, "procs": 3, "mesh": (4,)}
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("how", [signal.SIGKILL, signal.SIGSTOP],
                         ids=["dead", "silent"])
def test_a_lost_rank_ends_the_run_within_its_timeout(how):
    # rank 1 dies (or stops answering) during the third call, while rank 0
    # is inside the call's collectives: the run raises within the group's
    # timeout, never hangs, and closing the driver reports the rank
    state = {}

    def hook(driver):
        state["driver"] = driver
        call = driver.call

        def lose_rank_1(i):
            if i == 2:
                os.kill(driver.procs[0].pid, how)
            call(i)
        driver.call = lose_rank_1
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        run_small(MESH, hook=hook, seconds=30.0)
    assert time.perf_counter() - t0 < 3 * TIMEOUT_S
    driver = state["driver"]
    procs = list(driver.procs)
    with pytest.raises(RuntimeError, match="failed"):
        driver.close()
    assert not torch.distributed.is_initialized()
    assert all(not p.is_alive() for p in procs)


ORPHAN = """
import multiprocessing, os, sys
sys.path.insert(0, {root!r})
from portbench.traffic import sharded_trajectory as st
if __name__ == "__main__":
    p = multiprocessing.get_context("spawn").Process(
        target=st._end_with, args=(os.getpid(),))
    p.start()
    print(p.pid, flush=True)
    os._exit(0)
"""


def exited(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in "ZX"
    except FileNotFoundError:
        return True


def test_a_rank_ends_itself_once_rank_0_is_gone():
    out = subprocess.run([sys.executable, "-c",
                          ORPHAN.format(root=str(run.ROOT))],
                         capture_output=True, text=True, timeout=120)
    pid = int(out.stdout.split()[0])
    deadline = time.perf_counter() + 30.0
    while not exited(pid) and time.perf_counter() < deadline:
        time.sleep(0.2)
    assert exited(pid)


def test_the_mesh_runs_on_one_rank():
    # the cell's ranks are its chips unless the workload names them: one
    # rank is the cell on one card
    seen = {}

    def hook(driver):
        seen["ranks"] = driver.ranks
        seen["procs"] = len(driver.procs)
    result = run.run_cell(MESH, SEED, 0.3, False, device="cpu",
                          workload_overrides={**SMALL[MESH], "ranks": 1},
                          driver_hook=hook)
    assert seen == {"ranks": 1, "procs": 0}
    assert result["correct"], result["checks"]


# ------------------------------------------------------------ the readers

def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def reading(events, calls=1, force=0.0, step=0.0):
    window = [ev("user_annotation", profiling.WINDOW_SPAN, 0.0, 1000.0)]
    return profiling.Reading(
        profiling.Trace(window + events), calls,
        {"passes": 1, "force": work.Work(fp32=67e12 * force),
         "step": work.Work(fp32=67e12 * step)})


MADE_UP = [
    # a call: the position gather alone, K1 with the next gather behind
    # it on NCCL's stream, the state's gather alone, then idle
    ev("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)", 0.0,
       100.0),
    ev("kernel", "void direct_force_kernel<4>(float const*)", 100.0, 600.0),
    ev("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)",
       650.0, 100.0),
    ev("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)",
       750.0, 50.0),
    # the host enqueues a gather while the device idles at [800, 900]
    ev("user_annotation", "nbody.comm", 850.0, 20.0),
    ev("user_annotation", "nbody.comm", 10.0, 5.0),
]


@pytest.fixture
def four_ranks(monkeypatch):
    monkeypatch.setattr(mesh, "ranks", lambda: 4)


def test_the_mesh_readers(four_ranks):
    # 600 us of K1; this card's share of a force bound of 1200 us is 300
    r = reading(MADE_UP, calls=2, force=600e-6, step=800e-6)
    assert read_metric("force_roofline.mesh", r) == pytest.approx(
        50.0)
    assert read_metric("step_mfu.mesh", r) == pytest.approx(40.0)
    # 250 us of NCCL kernels over 2 calls
    assert read_metric("comm.ms_per_call.mesh", r) == pytest.approx(
        0.125)
    # alone: [0, 100] and [700, 800]; idle inside a comm span: [850, 870]
    assert read_metric("comm.exposed.mesh", r) == pytest.approx(22.0)


def test_the_mesh_readers_without_their_layers_read_nothing(four_ranks):
    r = reading([ev("kernel", "void symmetric_force_kernel<128>()", 0.0,
                    500.0),
                 ev("user_annotation", "nbody.force", 0.0, 500.0)])
    assert read_metric("comm.ms_per_call.mesh", r) is None
    assert read_metric("comm.exposed.mesh", r) is None
    assert read_metric("force_roofline.mesh",
                            reading([ev("kernel", "k", 0.0, 10.0)])) is None


def test_one_rank_without_a_group():
    assert not torch.distributed.is_initialized()
    assert mesh.ranks() == 1
