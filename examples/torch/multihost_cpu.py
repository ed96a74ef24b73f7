"""Multi-process torch.distributed run of the sharded path on localhost
CPUs (counterpart of examples/multihost_cpu.py).

Each worker process is one gloo rank started as torchrun would start it
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK in its environment):

  * it calls parallel.multihost.initialize(device="cpu") (the wrapper a
    multi-card run calls with NCCL),
  * builds the 1-D body mesh over every rank (parallel.multihost.
    global_mesh),
  * runs a sharded trajectory (comm='ring_sym') whose every hop crosses the
    process boundary,
  * and checks the gathered result against a local single-process run.

Run: python examples/torch/multihost_cpu.py            (spawns 2 workers)
     python examples/torch/multihost_cpu.py --procs 4  (4 workers)
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

N = 96
STEPS = 3


def worker() -> None:
    import torch

    from mini_nbody_tpu_torch import SimConfig, init, simulate
    from mini_nbody_tpu_torch.parallel import multihost, simulate_sharded

    active = multihost.initialize(device="cpu")
    import torch.distributed as dist

    assert active and dist.get_world_size() == int(os.environ["WORLD_SIZE"])
    mesh = multihost.global_mesh()

    cfg = SimConfig(n=N, dt=1e-3, steps=STEPS, softening=1e-2,
                    backend="torch", comm="ring_sym", use_masses=True)
    gen = torch.Generator().manual_seed(0)
    state = init.plummer(N, generator=gen, device="cpu")  # same on every rank

    final = simulate_sharded(cfg, mesh, state)  # gathered on every rank

    # The correctness anchor: a local single-process trajectory.
    ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather"), state)
    scale = float(ref.pos.abs().max())
    err = float((final.pos - ref.pos).abs().max()) / scale
    if not err < 1e-5:
        raise SystemExit(f"rank {dist.get_rank()}: err {err}")
    if multihost.is_primary():
        print(f"multihost OK: {mesh.size} processes, {STEPS} sharded "
              f"steps, max err {err:.2e}")
    dist.destroy_process_group()


def main(num_processes: int = 2) -> int:
    with socket.socket() as s:  # a free localhost port for the store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                         "LOCAL_RANK")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            env=dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE=str(num_processes), RANK=str(i),
                     LOCAL_RANK=str(i), OMP_NUM_THREADS="1"),
            cwd=ROOT)
        for i in range(num_processes)
    ]
    # Any hang or raise kills every surviving worker.
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            if p.poll() is None:
                p.wait(timeout=10)
    if any(rcs):
        raise SystemExit(f"worker exit codes {rcs}")
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="accepted for the other demos' command line: the "
                         "gloo ranks run on the CPU in any case")
    args = ap.parse_args()
    if args.worker:
        worker()
    else:
        sys.exit(main(args.procs))
