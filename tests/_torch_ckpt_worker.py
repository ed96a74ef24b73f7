"""One gloo rank of the port's sharded checkpoints on the CPU, for
tests/test_torch_utils.py. Imports torch, numpy and the port only.

    python tests/_torch_ckpt_worker.py WORLD RANK RENDEZVOUS_FILE ROOT

joins a WORLD-rank gloo group through ``file://RENDEZVOUS_FILE`` and, on a
1-D mesh over it, saves its block of ck_state() to ROOT/ck_w{WORLD} with
save_sharded (no collective but barriers), then restores its block bitwise
from that checkpoint and from ROOT/ck_w1 (written by one rank). Exits
non-zero on any mismatch.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

#: The checkpointed state: N = 101 (no mesh of 2 or 4 divides it), unit
#: masses, FAR pads (as simulate_sharded shards a unit-mass config).
N = 101


def ck_state():
    from mini_nbody_tpu_torch import BodyState

    rng = np.random.default_rng(11)
    pos = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    vel = (0.1 * rng.normal(size=(N, 3))).astype(np.float32)
    return BodyState.from_numpy(pos, vel, np.ones(N, np.float32),
                                device="cpu")


def run(world: int, rank: int, rdv: str, root: str) -> None:
    import torch
    import torch.distributed as dist

    from mini_nbody_tpu_torch import SimConfig, make_mesh
    from mini_nbody_tpu_torch.parallel.sharded import shard_state
    from mini_nbody_tpu_torch.utils import checkpoint as ckpt
    from mini_nbody_tpu_torch.utils import tracing

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("pos", "vel", "mass"))

    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(world)
        local = shard_state(ck_state(), mesh, pad_far=True)
        before = tracing.counters()
        path = ckpt.save_sharded(Path(root) / f"ck_w{world}", mesh, local,
                                 step=5 + world, cfg=SimConfig(n=N))
        made = {k: v for k, v in (tracing.counters() - before).items()
                if k.startswith("comm.")}
        if made:
            raise SystemExit(f"save_sharded made collectives: {made}")
        for src in (path, Path(root) / "ck_w1"):
            back, _, _ = ckpt.load_sharded(src, mesh, pad_far=True)
            if not same(back, local):
                raise SystemExit(f"rank {rank}: {src.name} did not restore "
                                 "its block bitwise")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
