"""Trajectory checkpoint and resume.

Counterpart of ``mini_nbody_tpu/utils/checkpoint.py:25-130``. ``save`` /
``load`` keep JAX's npz layout (``pos``, ``vel``, ``mass`` and ``meta``,
JSON with ``step`` and ``config``) and its suffix normalisation, so each
package reads the other's arrays bitwise; ``restore_config`` takes a config
dict written by either package.

``save_sharded`` / ``load_sharded`` stand where JAX's ``save_orbax`` /
``load_orbax`` do (Orbax has no torch analog): a directory of per-rank npz
files, one per rank of the mesh, each holding the rank's own rows of a
``parallel.shard_state`` block and written by that rank with no gather,
plus ``meta.json`` (step, n, the saved world size and its block rows,
config). The pads ``shard_state`` adds are not saved: the body count n is.
The write is atomic: every rank writes into ``<path>.tmp``, and rank 0
renames it to ``<path>`` after a barrier. ``load_sharded`` restores onto a
mesh of any world size, each rank reading only the files that hold its
rows, or returns the whole state without a mesh. The ranks must share the
file system that holds ``path``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mini_nbody_tpu_torch.models.state import BodyState
from mini_nbody_tpu_torch.utils.config import JAX_BACKENDS, SimConfig, round_up

META = "meta.json"


def _normalize(path) -> Path:
    # np.savez appends '.npz' when missing; normalize up front so save()
    # reports the file that actually exists and load() finds it.
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz")


def save(path, state: BodyState, step: int = 0,
         cfg: Optional[SimConfig] = None) -> Path:
    """Write a checkpoint; returns the actual path written (suffix
    normalized to .npz). Tensors are copied to the host."""
    path = _normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {"step": int(step)}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    pos, vel, mass = state.to_numpy()
    np.savez(path, pos=pos, vel=vel, mass=mass, meta=json.dumps(meta))
    return path


def load(path, device="cuda") -> Tuple[BodyState, int, Optional[dict]]:
    """Read a checkpoint -> (state on ``device``, step, config dict or
    None)."""
    with np.load(_normalize(path), allow_pickle=False) as z:
        state = BodyState.from_numpy(z["pos"], z["vel"], z["mass"],
                                     device=device)
        meta = json.loads(str(z["meta"]))
    return state, meta.get("step", 0), meta.get("config")


def restore_config(cfg_dict: dict) -> SimConfig:
    """The SimConfig of a checkpoint's config dict, from either package: a
    dict whose backend is a JAX name goes through SimConfig.from_dict
    (JAX's names mapped, ``interpret`` dropped), a port dict straight to
    SimConfig."""
    if cfg_dict.get("backend", "auto") in JAX_BACKENDS:
        return SimConfig.from_dict(cfg_dict)
    if cfg_dict.get("mesh_shape") is not None:
        cfg_dict = dict(cfg_dict, mesh_shape=tuple(cfg_dict["mesh_shape"]))
    return SimConfig(**cfg_dict)


def _rank_file(root: Path, rank: int) -> Path:
    return root / f"rank{rank}.npz"


def save_sharded(path, mesh, state: BodyState, step: int = 0,
                 cfg: Optional[SimConfig] = None,
                 n: Optional[int] = None) -> Path:
    """Write this rank's block ``state`` (``parallel.shard_state``'s) of a
    sharded checkpoint, collective over the mesh: every rank calls it.
    n: the global body count (default cfg.n, else every row is a body);
    rows at or past n are pads and are not saved. Returns the directory."""
    import torch.distributed as dist

    from mini_nbody_tpu_torch.parallel.sharded import _check_mesh

    _check_mesh(mesh)
    path = Path(path).resolve()
    tmp = path.with_name(path.name + ".tmp")
    k = state.pos.shape[0]
    if n is None:
        n = cfg.n if cfg is not None else k * mesh.size
    if k * mesh.size != round_up(n, mesh.size):
        raise ValueError(f"a block of {k} rows on {mesh.size} ranks does not "
                         f"hold n={n} bodies as shard_state pads them")
    if mesh.index == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    dist.barrier(group=mesh.group)
    lo = mesh.index * k
    real = max(0, min(k, n - lo))
    pos, vel, mass = (t[:real] for t in state.to_numpy())
    np.savez(_rank_file(tmp, mesh.index), pos=pos, vel=vel, mass=mass)
    dist.barrier(group=mesh.group)
    if mesh.index == 0:
        meta = {"step": int(step), "n": int(n), "world": mesh.size,
                "rows": k}
        if cfg is not None:
            meta["config"] = dataclasses.asdict(cfg)
        (tmp / META).write_text(json.dumps(meta))
        old = path.with_name(path.name + ".old")
        if path.exists():
            path.rename(old)
        tmp.rename(path)
        shutil.rmtree(old, ignore_errors=True)
    dist.barrier(group=mesh.group)
    return path


def _read_rows(root: Path, meta: dict, lo: int, hi: int):
    """Global rows [lo, hi) (hi <= n) as numpy (pos, vel, mass), read from
    the rank files that hold them."""
    k = meta["rows"]
    parts = []
    for r in range(lo // k, -(-hi // k)):
        with np.load(_rank_file(root, r), allow_pickle=False) as z:
            a, b = max(lo - r * k, 0), min(hi - r * k, k)
            parts.append(tuple(z[f][a:b] for f in ("pos", "vel", "mass")))
    if not parts:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0,), np.float32))
    return tuple(np.concatenate(c) for c in zip(*parts))


def load_sharded(path, mesh=None, device="cuda", pad_far: bool = False
                 ) -> Tuple[BodyState, int, Optional[dict]]:
    """Read a save_sharded checkpoint -> (state, step, config dict or
    None). Without a mesh the whole state, on ``device``. With one, this
    rank's block as ``parallel.shard_state(whole, mesh, pad_far)`` gives
    it, on the mesh's device, read from the files holding its rows: the
    mesh's world size need not be the saved one."""
    root = Path(path).resolve()
    meta = json.loads((root / META).read_text())
    n = meta["n"]
    if mesh is None:
        state = BodyState.from_numpy(*_read_rows(root, meta, 0, n),
                                     device=device)
        return state, meta["step"], meta.get("config")
    from mini_nbody_tpu_torch.parallel.sharded import _check_mesh

    _check_mesh(mesh)
    k = round_up(n, mesh.size) // mesh.size
    lo = mesh.index * k
    rows = _read_rows(root, meta, min(lo, n), min(lo + k, n))
    state = BodyState.from_numpy(*rows, device=mesh.device)
    return state.pad_to(k, far=pad_far), meta["step"], meta.get("config")
