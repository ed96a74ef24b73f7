"""Measured tile autotuner with a persistent cache per card.

Counterpart of ``mini_nbody_tpu/utils/autotune.py:1-459``. ``tune(cfg)``
times one step per candidate tiling on the card and returns a SimConfig
with the winner applied; results persist in a JSON cache keyed by (card
name, backend, mass mode, N bucket, pair_dtype, split_w, coincident), so
each point is measured once per machine. ``tune_ensemble`` does the same
for a B-system batch, the streamed ensemble kernels head to head with the
resident kernel. Autotuning is opt-in (``run --autotune``): no default
changes without it.

The candidates are the port's kernels' own, not JAX's VMEM tables:
``sym_tile`` the tiles K2 and K3 are built for, ``sym_chunk`` JAX's two
chunks (the port's sym kernels take any positive chunk, rounded up to a
multiple of the tile: ``sym_mxu_force._resolve_tiling``), ``tile_i`` K1's
rows a CTA, ``resident_tile`` and ``sym_bwd_tile`` the tiles B15 and
B11 / B13 are built for. ``mxu`` has nothing to tune: B6's tile is fixed
(``mxu_force.KERNEL_TILE``), and tile_i / tile_j only tile its plain
version.

Unlike JAX's tuner, which records any exception of a candidate as a failed
compile, ``_sweep`` records only the ValueError a wrapper raises for a
shape it refuses; a CUDA error, a build error or any other exception
propagates, so no kernel failure hides behind another candidate.

CLI: ``python -m mini_nbody_tpu_torch.cli tune --n 1048576 --backend sym``.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Callable, Optional

import torch

from mini_nbody_tpu_torch.ops.symmetric_force import KERNEL_TILES
from mini_nbody_tpu_torch.utils.config import (RESIDENT_TILES, SYM_BWD_TILES,
                                               SimConfig)
from mini_nbody_tpu_torch.utils.harness import NotOnCard

#: sym / sym_mxu tiles (K2's and K3's, ops/slot_pipe.py, symmetric_force.py).
SYM_TILES = KERNEL_TILES
#: Chunk candidates of the sym kernels' cross-chunk decomposition (measured
#: only when n spans more than one).
SYM_CHUNKS = (131072, 262144)
#: K1's rows a CTA (SimConfig.tile_i).
DIRECT_TILES = (256, 512, 1024)
#: Ensemble candidates of the streamed batched drivers' sym_tile; None is
#: the ensemble_tiling default.
ENSEMBLE_TILES = (None, *KERNEL_TILES)

CACHE_ENV = "NBODY_TUNE_CACHE"


def cache_path() -> pathlib.Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return pathlib.Path(env)
    base = pathlib.Path(os.environ.get(
        "XDG_CACHE_HOME", pathlib.Path.home() / ".cache"))
    return base / "mini_nbody_tpu_torch" / "autotune.json"


def _load(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {}


def _save(path: pathlib.Path, data: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(data, indent=1, sort_keys=True))
    tmp.replace(path)


def _bucket(n: int) -> int:
    """Round n up to a power of two: the optimum shifts with scale, not
    with every individual N."""
    b = 1
    while b < n:
        b *= 2
    return b


def device_name(device="cuda") -> str:
    """The card's name as the cache keys it (spaces as '_'); raises
    without a CUDA card, since every entry is a card measurement."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise NotOnCard(f"autotune measures on a CUDA card; got {device} "
                        f"(CUDA available: {torch.cuda.is_available()})")
    return torch.cuda.get_device_name(device).replace(" ", "_")


def _key(cfg: SimConfig, ensemble: int = 0, device="cuda") -> str:
    parts = [
        device_name(device), cfg.effective_backend(),
        "mass" if cfg.use_masses else "unit", str(_bucket(cfg.n)),
        cfg.pair_dtype, "wsplit" if cfg.split_w else "w1",
        cfg.coincident,
    ]
    if ensemble:
        parts.append(f"ens{_bucket(ensemble)}")
    return "|".join(parts)


def _default_measure(cfg: SimConfig, reps: int, device="cuda") -> float:
    """Seconds per step of cfg on the card: make_step_fn's step between
    CUDA events, or, for a cfg.resident=True candidate, whole resident
    calls (shmoo.time_resident; its tile is what resident_tile tunes)."""
    from mini_nbody_tpu_torch.models import init
    from mini_nbody_tpu_torch.sim import init_carry, make_step_fn
    from mini_nbody_tpu_torch.utils.harness import time_step_fn
    from mini_nbody_tpu_torch.utils.shmoo import time_resident

    gen = torch.Generator(device=device).manual_seed(0)
    state = init.uniform_random(cfg.n, generator=gen, device=device)
    if cfg.resident:
        return time_resident(cfg, state, reps)
    return time_step_fn(make_step_fn(cfg), init_carry(cfg, state), reps=reps)


def _default_measure_bwd(cfg: SimConfig, reps: int, device="cuda") -> float:
    """Seconds per backward pass of the pair-once VJP kernel of cfg's
    class (B11 or B13) at cfg.sym_bwd_tile."""
    from mini_nbody_tpu_torch.models import init
    from mini_nbody_tpu_torch.utils.harness import time_fn

    gen = torch.Generator(device=device).manual_seed(0)
    state = init.uniform_random(cfg.n, generator=gen, device=device)
    g = state.pos + 1.0
    mass = state.mass if cfg.use_masses else None
    if cfg.bf16_class():
        from mini_nbody_tpu_torch.ops.vjp_mxu import vjp_pos_sym_mxu as vjp
    else:
        from mini_nbody_tpu_torch.ops.vjp_kernel import vjp_pos_sym as vjp

    def run():
        return vjp(state.pos, g, mass, softening=float(cfg.softening),
                   tile=cfg.sym_bwd_tile, coincident=cfg.coincident)

    return time_fn(run, reps=reps, device=device)


def _default_measure_ensemble(cfg: SimConfig, b: int, reps: int,
                              device="cuda") -> float:
    """Seconds per step of a B-system simulate_ensemble run at cfg's plan
    (resident True pins the resident kernel at cfg.resident_tile, False
    the streamed kernels at cfg.sym_tile), over calls of ~10 ms or more."""
    from mini_nbody_tpu_torch.models import init
    from mini_nbody_tpu_torch.models.state import BodyState
    from mini_nbody_tpu_torch.sim import simulate_ensemble
    from mini_nbody_tpu_torch.utils.harness import time_steps_call
    from mini_nbody_tpu_torch.utils.shmoo import RESIDENT_STEPS

    n = cfg.n
    gen = torch.Generator(device=device).manual_seed(0)
    make = init.plummer if cfg.use_masses else init.uniform_random
    s = make(n, generator=gen, device=device)
    noise = torch.randn((b, n, 3), generator=gen, device=device)
    state = BodyState(pos=(s.pos[None] + 1e-3 * noise).contiguous(),
                      vel=s.vel.expand(b, n, 3).contiguous(),
                      mass=s.mass.expand(b, n).contiguous())
    return time_steps_call(
        lambda k: simulate_ensemble(cfg, state, steps=k), device,
        RESIDENT_STEPS, reps)


def _candidates(cfg: SimConfig):
    eff = cfg.effective_backend()
    if eff in ("sym", "sym_mxu"):
        return [cfg.replace(sym_tile=t) for t in SYM_TILES]
    if eff == "direct":
        return [cfg.replace(tile_i=t) for t in DIRECT_TILES]
    return [cfg]  # torch, mxu: nothing to tune


def _params(cfg: SimConfig) -> dict:
    return {"sym_tile": cfg.sym_tile, "sym_chunk": cfg.sym_chunk,
            "tile_i": cfg.tile_i, "tile_j": cfg.tile_j,
            "sym_bwd_tile": cfg.sym_bwd_tile,
            "resident_tile": cfg.resident_tile}


#: Tiling fields each backend family tunes; a cache hit applies ONLY these
#: (and only where the user left the SimConfig default), so
#: `run --autotune --sym-chunk 65536` keeps the explicit chunk.
FAMILY_PARAMS = {
    "sym": ("sym_tile", "sym_chunk", "sym_bwd_tile", "resident_tile"),
    "sym_mxu": ("sym_tile", "sym_chunk", "sym_bwd_tile", "resident_tile"),
    "direct": ("tile_i",),
}

#: Fields the ensemble family tunes: the streamed batched drivers' sym_tile
#: and the resident route pinned (True / False) with its own tile.
ENSEMBLE_FAMILY_PARAMS = ("sym_tile", "resident", "resident_tile")


def _apply_cached(cfg: SimConfig, params: dict,
                  fields: tuple | None = None) -> SimConfig:
    """Apply a cached result to cfg: family-tuned fields only, user
    overrides (any field differing from the dataclass default) kept."""
    defaults = SimConfig(n=cfg.n)
    keep = {}
    for k in fields or FAMILY_PARAMS.get(cfg.effective_backend(), ()):
        if k in params and getattr(cfg, k) == getattr(defaults, k):
            keep[k] = params[k]
    return cfg.replace(**keep)


def _sweep(cands, measure, reps, results):
    """(best_cand, best_sec) over candidates. A candidate whose wrapper
    refuses its shape (ValueError) is recorded as failed; every other
    exception propagates."""
    best, best_sec = None, float("inf")
    for cand in cands:
        try:
            sec = measure(cand, reps)
        except ValueError as e:
            results[json.dumps(_params(cand))] = f"failed: {str(e)[:80]}"
            continue
        results[json.dumps(_params(cand))] = sec
        if sec < best_sec:
            best, best_sec = cand, sec
    return best, best_sec


def tune(
    cfg: SimConfig,
    reps: int = 2,
    use_cache: bool = True,
    measure: Optional[Callable[[SimConfig, int], float]] = None,
    path: Optional[pathlib.Path] = None,
    backward: bool = False,
    measure_bwd: Optional[Callable[[SimConfig, int], float]] = None,
    device="cuda",
) -> SimConfig:
    """Return cfg with the measured-fastest tiling for its backend applied.

    Phases:
      1. the family's tile sweep (sym_tile, or tile_i for direct); a
         cfg.resident=True config sweeps resident_tile only;
      2. sym_chunk at the winning tile, when N spans more than one chunk;
      3. with backward=True: sym_bwd_tile of the pair-once VJP kernel of
         the config's class.

    `measure` / `measure_bwd` (seconds from (cfg, reps)) are injectable for
    tests; the defaults time on ``device``. With use_cache, a prior result
    for the same key is applied without measuring (family fields only,
    explicit user overrides kept). use_cache=False skips the read only:
    fresh results are always written."""
    measure = measure or (lambda c, r: _default_measure(c, r, device))
    measure_bwd = measure_bwd or (
        lambda c, r: _default_measure_bwd(c, r, device))
    path = path or cache_path()
    key = _key(cfg, device=device)
    if use_cache:
        hit = _load(path).get(key)
        if hit and (not backward
                    or hit["params"].get("sym_bwd_tile") is not None):
            return _apply_cached(cfg, hit["params"])

    results = {}
    eff = cfg.effective_backend()
    if cfg.resident and eff in ("sym", "sym_mxu"):
        # The resident kernel ignores sym_tile and sym_chunk.
        best, best_sec = _sweep(
            [cfg.replace(resident_tile=t) for t in RESIDENT_TILES],
            measure, reps, results)
    else:
        best, best_sec = _sweep(_candidates(cfg), measure, reps, results)
    if best is None:
        raise RuntimeError(
            f"autotune: every candidate failed for {key}: {results}")

    if (not cfg.resident and eff in ("sym", "sym_mxu")
            and cfg.n > min(SYM_CHUNKS)):
        chunk_best, chunk_sec = _sweep(
            [best.replace(sym_chunk=c) for c in SYM_CHUNKS
             if c != (best.sym_chunk or 131072)],
            measure, reps, results)
        if chunk_best is not None and chunk_sec < best_sec:
            best, best_sec = chunk_best, chunk_sec

    if backward and eff in ("sym", "sym_mxu"):
        bwd_best, _ = _sweep(
            [best.replace(sym_bwd_tile=t) for t in SYM_BWD_TILES],
            measure_bwd, reps, results)
        if bwd_best is not None:
            best = best.replace(sym_bwd_tile=bwd_best.sym_bwd_tile)

    data = _load(path)
    data[key] = {
        "params": _params(best),
        "seconds": best_sec,
        "ginter_s": float(cfg.n) * cfg.n / best_sec / 1e9,
        "results": results,
    }
    _save(path, data)
    return best


def tune_ensemble(
    cfg: SimConfig,
    b: int,
    reps: int = 2,
    use_cache: bool = True,
    measure: Optional[Callable[[SimConfig, int, int], float]] = None,
    path: Optional[pathlib.Path] = None,
    device="cuda",
) -> SimConfig:
    """Return cfg with the measured-fastest ensemble plan for a B-system
    batch applied: the streamed drivers' sym_tile over ENSEMBLE_TILES head
    to head with the resident kernel at each RESIDENT_TILES tile that holds
    all B systems (sim._resident_ensemble_admissible), the winner pinned
    (resident True / False and its tile). Keyed like tune, plus the B
    bucket.

    CLI: ``tune --ensemble B`` fills the cache; ``run --ensemble B
    --autotune`` reads it."""
    from mini_nbody_tpu_torch.sim import (_RESIDENT_INTEGRATORS,
                                          _resident_ensemble_admissible)

    measure = measure or (
        lambda c, bb, r: _default_measure_ensemble(c, bb, r, device))
    path = path or cache_path()
    key = _key(cfg, ensemble=b, device=device)
    if use_cache:
        hit = _load(path).get(key)
        if hit:
            return _apply_cached(cfg, hit["params"],
                                 ENSEMBLE_FAMILY_PARAMS)

    results = {}
    streamed = [cfg.replace(sym_tile=t, resident=False)
                for t in ENSEMBLE_TILES]
    resident = []
    if cfg.integrator in _RESIDENT_INTEGRATORS:
        resident = [c for c in (cfg.replace(resident=True, resident_tile=t)
                                for t in RESIDENT_TILES)
                    if _resident_ensemble_admissible(c, b)]

    def meas(cand, r):
        return measure(cand, b, r)

    best, best_sec = _sweep(streamed + resident, meas, reps, results)
    if best is None:
        raise RuntimeError(
            f"tune_ensemble: every candidate failed for {key}: {results}")

    data = _load(path)
    params = dict(_params(best))
    params["resident"] = bool(best.resident)
    data[key] = {
        "params": params,
        "seconds": best_sec,
        "g_pairs_s": b * float(cfg.n) * cfg.n / best_sec / 1e9,
        "results": results,
    }
    _save(path, data)
    return best


def cached_rate(cfg: SimConfig, path: Optional[pathlib.Path] = None,
                device="cuda") -> Optional[float]:
    """Measured GInteractions/s from a prior tune of this config's cache
    key, or None."""
    hit = _load(path or cache_path()).get(_key(cfg, device=device))
    if not hit:
        return None
    rate = hit.get("ginter_s")
    return float(rate) if rate else None
