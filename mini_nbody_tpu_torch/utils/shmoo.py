"""Shmoo sweep: a scaling study over N (BASELINE.json config 5).

Counterpart of ``mini_nbody_tpu/utils/shmoo.py:25-113``: sweep N, time one
step on the card, report GInteractions/s and the roofline fraction, emit
CSV or JSON lines (the same FIELDS, so the same rows give the same text).
"""

from __future__ import annotations

import csv
import io
import json
from typing import List, Optional

import torch

from mini_nbody_tpu_torch.models import init as minit
from mini_nbody_tpu_torch.utils import harness
from mini_nbody_tpu_torch.utils.config import SimConfig

FIELDS = ["n", "backend", "seconds", "ginteractions_per_s", "per_device",
          "gflops_20c", "roofline_frac"]

#: Steps of the first timed resident call: at least every integrator's
#: sim.RESIDENT_AUTO_MIN_STEPS, so the routing asked about is the call's.
RESIDENT_STEPS = 20


def time_resident(cfg: SimConfig, state, reps: int) -> float:
    """Seconds per step of ``simulate(cfg.replace(resident=True))``, one
    resident launch per call (the path simulate takes where it routes
    resident), over calls of enough steps to hold ~10 ms of card time."""
    from mini_nbody_tpu_torch.sim import simulate

    c = cfg.replace(resident=True)
    return harness.time_steps_call(lambda k: simulate(c, state, steps=k),
                                   state.pos.device, RESIDENT_STEPS, reps)


def sweep(cfg: SimConfig, ns: List[int], reps: int = 3,
          mesh: Optional[object] = None, device="cuda") -> List[dict]:
    """Time one integration step per N in ns (uniform bodies from seed 0 on
    ``device``, or on the mesh's); returns report rows.

    Rows follow simulate()'s own routing: a single-card config that routes
    the resident kernel (sim._route_resident for a call of the timed
    length) is timed on it and labelled ``<backend>_resident``; every
    other row times make_step_fn's step (the sharded step on a mesh)."""
    from mini_nbody_tpu_torch.sim import (_route_resident, init_carry,
                                          make_step_fn)

    rows = []
    n_devices = 1 if mesh is None else mesh.size
    device = torch.device(device if mesh is None else mesh.device)
    for n in ns:
        c = cfg.replace(n=n)
        gen = torch.Generator(device=device).manual_seed(0)
        state = minit.uniform_random(n, generator=gen, device=device)
        if mesh is None and _route_resident(c, RESIDENT_STEPS, device):
            sec = time_resident(c, state, reps)
            t = harness.Throughput(n=n, steps=1, seconds=sec)
            row = {"backend": c.effective_backend() + "_resident",
                   **t.report(path=harness.roofline_path(c))}
            row.pop("steps", None)
            rows.append(row)
            continue
        if mesh is None:
            step, carry = make_step_fn(c), init_carry(c, state)
        else:
            from mini_nbody_tpu_torch.parallel.sharded import (
                init_sharded_carry, make_sharded_step_fn, shard_state)

            local = shard_state(state, mesh, pad_far=not c.use_masses)
            step = make_sharded_step_fn(c, mesh)
            carry = init_sharded_carry(c, mesh, local)
        sec = harness.time_step_fn(step, carry, reps=reps)
        t = harness.Throughput(n=n, steps=1, seconds=sec,
                               n_devices=n_devices)
        sharded = mesh is not None
        row = {"backend": c.effective_backend(sharded=sharded),
               **t.report(path=harness.roofline_path(c, sharded=sharded))}
        row.pop("steps", None)
        rows.append(row)
    return rows


def to_csv(rows: List[dict]) -> str:
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=FIELDS)
    w.writeheader()
    for r in rows:
        w.writerow({k: r.get(k) for k in FIELDS})
    return buf.getvalue()


def to_jsonl(rows: List[dict]) -> str:
    return "\n".join(json.dumps(r) for r in rows)
