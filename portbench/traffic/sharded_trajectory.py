"""Streamed trajectories of one system sharded over ranks: BASELINE config
4's deployment, through ``parallel.simulate_sharded``.

Each timed call is ``simulate_sharded(cfg, mesh, state, steps=
steps_per_call)`` from the previous call's state, on every rank at once:
each rank keeps its block of the bodies, gathers every rank's positions
once a step (the configuration's ``comm``) and the whole state once a call,
so every rank holds the call's output. ``restart_every`` restarts the chain
from the seed's bodies, as ``trajectory`` does, whose check this kind
keeps: it runs on rank 0 over the gathered state. The check adds
``rank_diff``: after the window rank 0 broadcasts the inputs and outputs of
the calls it checks (the first ``restart_every`` calls and the last), and
every other rank counts the elements in which its own copies differ, so
that each rank is held to the whole state the configuration promises it.

Rank 0 is the benchmark's own process and the only one the benchmark
times and traces. It builds the port's library before it starts ranks 1 to
``ranks - 1`` (``spawn`` processes), so that no two ranks build at once;
``ranks`` is the cell's ``chips`` unless the workload names it (one rank
runs the cell on one card).
Each rank runs on its own card (``cuda:<rank>``, NCCL; gloo on the CPU),
joins the group through a ``file://`` rendezvous in a fresh temporary
folder and makes the same global state from the seed. Before each call
rank 0 broadcasts whether the call starts from the seed's bodies or from
the last call's state, in one collective of one number already on the card,
and after the window it broadcasts the comparison of the ranks' records and
then stop.

No run hangs: the group's collectives give up after ``TIMEOUT_S`` (NCCL's
watchdog then ends the process), rank 0 refuses a call once a rank has
exited, a rank ends itself once rank 0's process is gone, and ``release``
leaves the group with the other ranks (NCCL's teardown is a collective of
every rank on the node) and joins them for at most ``TIMEOUT_S``, killing
any that is left and raising.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import shutil
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from portbench import compare, inputs, run
from portbench.traffic import sim_config
from portbench.traffic import trajectory

#: The broadcast's commands: stop, a call from the seed's bodies, a call
#: from the last call's state, the comparison of the ranks' records.
STOP, FROM_SEED, FROM_LAST, COMPARE = 0, 1, 2, 3

#: Seconds a collective of the group waits before it gives up.
TIMEOUT_S = 180.0


def _mesh_config(config, n, steps, control, ranks):
    return sim_config(config, n, steps, control).replace(
        comm=config["comm"], mesh_shape=(ranks,))


def _join(rank, ranks, rendezvous, timeout_s, device):
    """Join the group as ``rank`` on its own device; returns the device."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=rendezvous,
                                world_size=ranks, rank=rank,
                                timeout=timeout, device_id=dev)
        return dev
    dist.init_process_group("gloo", init_method=rendezvous,
                            world_size=ranks, rank=rank, timeout=timeout)
    return torch.device("cpu")


def _sharded_run(cfg, mesh, spc):
    from mini_nbody_tpu_torch import BodyState
    from mini_nbody_tpu_torch.parallel import simulate_sharded

    def run(pos, vel, mass):
        out = simulate_sharded(cfg, mesh, BodyState(pos, vel, mass),
                               steps=spc)
        return out.pos, out.vel

    return run


def _inputs(cmd, s0, cur):
    """A call's positions and velocities: the seed's or the last call's."""
    return s0[:2] if cmd == FROM_SEED else cur


def _records(first, last):
    """The tensors of the records rank 0 checks, in one order on every
    rank: each call's inputs and outputs, the first calls' and the last."""
    return [t for (pos, vel), out in [*first, last] for t in (pos, vel, *out)]


def _rank_diff(mine, dev):
    """Collective of every rank: the elements of ``mine`` that differ from
    rank 0's records, summed over the ranks (0 on rank 0 itself)."""
    diff = torch.zeros(1, dtype=torch.int64, device=dev)
    root = dist.get_rank() == 0
    for t in mine:
        theirs = t.contiguous() if root else torch.empty_like(t)
        dist.broadcast(theirs, 0)
        if not root:
            diff += compare.mismatches(t, theirs)
    dist.all_reduce(diff)
    return int(diff.item())


def _end_with(parent):
    """End this process once ``parent`` (rank 0's) is gone, so that no rank
    is left holding its card in a collective that never completes."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _rank(rank, ranks, rendezvous, timeout_s, device, config, workload,
          seed, control):
    """Ranks 1 to ``ranks - 1``: the calls rank 0 broadcasts, until stop."""
    threading.Thread(target=_end_with, args=(os.getppid(),),
                     daemon=True).start()
    os.dup2(2, 1)  # the last line of standard output is rank 0's result
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev = _join(rank, ranks, rendezvous, timeout_s, device)
    try:
        from mini_nbody_tpu_torch import make_mesh

        mesh = make_mesh()
        n, spc = workload["n"], workload["steps_per_call"]
        run = _sharded_run(_mesh_config(config, n, spc, control, ranks),
                           mesh, spc)
        s0 = inputs.make(config["init"], n, seed, dev)
        keep = workload.get("restart_every") or 1
        cur, first, last, i = None, [], None, -1  # call -1 is the warm-up
        msg = torch.zeros(1, dtype=torch.int64, device=dev)
        while True:
            dist.broadcast(msg, 0)
            cmd = msg.item()
            if cmd == STOP:
                break
            if cmd == COMPARE:
                _rank_diff(_records(first, last), dev)
                continue
            pos, vel = _inputs(cmd, s0, cur)
            cur = run(pos, vel, s0[2])
            if 0 <= i < keep:
                first.append(((pos, vel), cur))
            last, i = ((pos, vel), cur), i + 1
    finally:
        dist.destroy_process_group()


class Driver(trajectory.Driver):
    def __init__(self, config, workload, seed, device, control=False):
        super().__init__(config, workload, seed, device, control)
        # the module as imported, not run.py's copy of this file: the
        # ranks' target pickles by its import path, and tests patch it
        me = importlib.import_module("portbench.traffic.sharded_trajectory")
        self.ranks = int(workload.get("ranks") or run.cell_entry(
            run.load_json(run.ROOT / "BENCHMARK.json"),
            workload["name"])["chips"])
        self.timeout_s = me.TIMEOUT_S
        self.rank_diff = None
        self.procs = []
        self.tmp = tempfile.mkdtemp(prefix="portbench-rdv-")
        if self.device.type == "cuda":
            from mini_nbody_tpu_torch import _build

            _build.load_library()
        rendezvous = f"file://{os.path.join(self.tmp, 'rendezvous')}"
        ctx = multiprocessing.get_context("spawn")
        for rank in range(1, self.ranks):
            p = ctx.Process(
                target=me._rank, daemon=True,
                args=(rank, self.ranks, rendezvous, self.timeout_s,
                      self.device.type, config, workload, seed, control))
            p.start()
            self.procs.append(p)
        dev = _join(0, self.ranks, rendezvous, self.timeout_s,
                    self.device.type)
        from mini_nbody_tpu_torch import make_mesh

        self.mesh = make_mesh()
        self.run = _sharded_run(
            _mesh_config(config, self.n, self.spc, control, self.ranks),
            self.mesh, self.spc)
        # each command on the card once: no copy to the card a call
        self._msgs = [torch.full((1,), cmd, dtype=torch.int64, device=dev)
                      for cmd in (STOP, FROM_SEED, FROM_LAST, COMPARE)]
        self.dev = dev

    def _tell(self, cmd):
        dead = [(r, p.exitcode) for r, p in enumerate(self.procs, 1)
                if not p.is_alive()]
        if dead:
            raise RuntimeError(f"sharded_trajectory: ranks {dead} (rank, "
                               "exit code) left the group")
        dist.broadcast(self._msgs[cmd], 0)

    def warm_up(self):
        self._tell(FROM_SEED)
        super().warm_up()

    def call(self, i):
        phase = i % self.restart if self.restart else i
        self._tell(FROM_SEED if phase == 0 else FROM_LAST)
        super().call(i)

    def release(self):
        super().release()
        self._tell(COMPARE)
        first = [self.first[phase] for phase in sorted(self.first)]
        self.rank_diff = _rank_diff(_records(first, self.last), self.dev)
        self._tell(STOP)
        dist.destroy_process_group()  # with the other ranks, as they stop
        self.close()

    def check(self):
        return {**super().check(), "rank_diff": self.rank_diff}

    def close(self):
        """Join the other ranks for at most timeout_s and leave the group if
        still in it; raises if a rank had to be killed or failed."""
        failed = []
        for rank, p in enumerate(self.procs, 1):
            p.join(self.timeout_s)
            if p.is_alive():
                p.kill()
                p.join()
                failed.append((rank, "killed"))
            elif p.exitcode != 0:
                failed.append((rank, p.exitcode))
        self.procs = []
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.tmp, ignore_errors=True)
        if failed:
            raise RuntimeError(f"sharded_trajectory: ranks {failed} "
                               "(rank, exit code) failed")
