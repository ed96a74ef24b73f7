"""Force-op dispatcher: one API over the plain, direct, sym, sym_mxu and mxu
paths.

Counterpart of ``mini_nbody_tpu/ops/force.py:16-122``. Backends: "torch"
(plain all-pairs, JAX "jnp"), "direct" (K1, JAX "pallas"), "sym" (K3, the
fp32 pair-once kernel), "sym_mxu" (K2), "mxu" (B6, the ordered tensor-core
hybrid, square or rectangular, in the class pair_dtype names) and "auto".
"auto" is the fp32-exact class on every device: "sym" for a square
self-force call (pos_j is pos_i) and "direct" for a rectangular one, the
ordered kernel JAX routes rectangular exchanges of "sym" to
(``mini_nbody_tpu/utils/config.py:189-194``).
"""

from __future__ import annotations

from mini_nbody_tpu_torch.ops.reference import body_force_torch
from mini_nbody_tpu_torch.utils.config import (AUTO_BACKEND, SOFTENING,
                                               SimConfig)
from mini_nbody_tpu_torch.utils.tracing import annotate

#: Element bound of the plain backend's (rows, Nj) intermediate.
_TORCH_BLOCK_ELEMS = 1 << 24


def body_force(pos_i, pos_j, mass_j=None, softening: float = SOFTENING,
               backend: str = "torch", tile_i: int = 256,
               tile_j: int = 1024, pair_dtype: str = "float32",
               split_w: bool = False, traversal: str = "auto",
               sym_tile: int | None = None, sym_chunk: int | None = None,
               coincident: str = "auto"):
    """Forces on pos_i (Ni,3) from sources (pos_j, mass_j): (Ni,3) fp32.

    tile_i is the direct kernel's block size and, with tile_j, the tiling
    of the mxu plain version; pair_dtype is mxu's precision class;
    sym_tile / sym_chunk override the sym and sym_mxu defaults; split_w
    applies to sym_mxu, coincident to sym_mxu and to square mxu calls.
    One call is one force pass: one nbody.force span."""
    with annotate("nbody.force"):
        return dispatch(pos_i, pos_j, mass_j, softening, backend, tile_i,
                        tile_j, pair_dtype, split_w, traversal, sym_tile,
                        sym_chunk, coincident)


def dispatch(pos_i, pos_j, mass_j, softening, backend, tile_i, tile_j,
             pair_dtype, split_w, traversal, sym_tile, sym_chunk,
             coincident):
    """body_force without its span, for a caller whose pass is several
    calls (parallel/sharded.py's exchanges)."""
    if backend == "auto":
        backend = AUTO_BACKEND if pos_i is pos_j else "direct"
    if backend == "torch":
        rows = max(1, _TORCH_BLOCK_ELEMS // max(1, pos_j.shape[0]))
        return body_force_torch(pos_i, pos_j, mass_j, softening=softening,
                                row_chunk=rows)
    if backend == "direct":
        from mini_nbody_tpu_torch.ops.direct_force import body_force_direct

        return body_force_direct(pos_i, pos_j, mass_j, softening=softening,
                                 block=tile_i)
    if backend == "mxu":
        from mini_nbody_tpu_torch.ops.mxu_force import body_force_mxu

        return body_force_mxu(pos_i, pos_j, mass_j, softening=softening,
                              tile_i=tile_i, tile_j=tile_j,
                              pair_dtype=pair_dtype, coincident=coincident)
    if backend in ("sym", "sym_mxu"):
        if pos_i is not pos_j:
            raise ValueError(
                f"backend {backend!r} computes square self-forces only: "
                "pos_j must be the same tensor as pos_i (use "
                "backend='direct' or 'mxu' for rectangular calls)")
        kw = {}
        if sym_tile is not None:
            kw["tile"] = sym_tile
        if sym_chunk is not None:
            kw["chunk"] = sym_chunk
        if backend == "sym":
            if traversal not in ("auto", "slots"):
                raise ValueError("backend 'sym' runs the slot traversal "
                                 f"only, got traversal={traversal!r}")
            from mini_nbody_tpu_torch.ops.symmetric_force import (
                body_force_symmetric)

            return body_force_symmetric(pos_i, mass_j, softening=softening,
                                        **kw)
        from mini_nbody_tpu_torch.ops.sym_mxu_force import body_force_sym_mxu

        return body_force_sym_mxu(pos_i, mass_j, softening=softening,
                                  split_w=split_w, coincident=coincident,
                                  traversal=traversal, **kw)
    raise ValueError(f"unknown force backend {backend!r}")


def make_force_fn(cfg: SimConfig):
    """Close a SimConfig over body_force: (pos_i, pos_j, mass_j) -> (Ni,3)."""
    backend = cfg.effective_backend()

    def force(pos_i, pos_j, mass_j=None):
        if not cfg.use_masses:
            mass_j = None  # unit masses: the kernels' mass-free path
        return body_force(
            pos_i, pos_j, mass_j, softening=cfg.softening, backend=backend,
            tile_i=cfg.tile_i, tile_j=cfg.tile_j, pair_dtype=cfg.pair_dtype,
            split_w=cfg.split_w, traversal=cfg.traversal,
            sym_tile=cfg.sym_tile, sym_chunk=cfg.sym_chunk,
            coincident=cfg.coincident)

    return force
