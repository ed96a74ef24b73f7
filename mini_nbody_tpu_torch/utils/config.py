"""Simulation configuration for the PyTorch port.

Counterpart of ``mini_nbody_tpu/utils/config.py:18-287``: the same physical
constants and the same frozen ``SimConfig`` with the same validation, cut to
the fields the port honours. Fields whose features are not ported yet accept
only their defaults and raise ``NotImplementedError`` naming the ROADMAP
item otherwise. ``interpret`` is gone: there is no interpreter, a tensor on
the CPU takes each kernel's plain PyTorch version and a tensor on the card
takes the kernel.

Backend names follow PyTorch rather than JAX: ``"torch"`` is the plain
all-pairs op (JAX ``"jnp"``), ``"direct"`` the hand-written ordered kernel
(JAX ``"pallas"``), ``"sym"`` the fp32 pair-once kernel, ``"sym_mxu"`` the
pair-once tensor-core kernel, and ``"auto"`` resolves to ``"sym"`` on every
device, as JAX's single-chip ``auto`` does
(``mini_nbody_tpu/utils/config.py:246-254``): a CUDA state runs the kernel,
a CPU state its plain version. ``fast_rsqrt_cube`` moves here from
``mini_nbody_tpu/ops/pallas_compat.py:22-23``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: Reference softening constant (fp32 1.0e-9), as in the JAX package.
SOFTENING = 1.0e-9

#: Reference step size.
DT = 0.01

#: Far-padding coordinate for tail bodies in unit-mass mode: r2 ~ 3e36 stays
#: finite in fp32 while rsqrt(r2^3) underflows to exactly 0, so padded bodies
#: are inert without a mass multiply.
FAR = 1.0e18

_BACKENDS = ("auto", "torch", "direct", "sym", "sym_mxu")
#: Backends of the JAX package that the port has not ported yet.
_UNPORTED_BACKENDS = {"mxu": "ROADMAP B6"}
#: JAX backend names -> port backend names (SimConfig.from_dict).
JAX_BACKENDS = {"auto": "auto", "jnp": "torch", "pallas": "direct",
                "sym_mxu": "sym_mxu", "sym": "sym", "mxu": "mxu"}
_INTEGRATORS = ("euler", "leapfrog", "rk4", "yoshida4")
_COMMS = ("all_gather", "ring", "ring_sym", "grid")

COINCIDENT_MODES = ("auto", "masked", "fast")


def check_coincident(value: str) -> str:
    """Validate a coincident-mode flag."""
    if value not in COINCIDENT_MODES:
        raise ValueError(
            f"coincident must be one of {COINCIDENT_MODES}, got {value!r}")
    return value


#: What backend='auto' runs, on every device: the fp32-exact pair-once
#: kernel, as JAX's single-chip auto does.
AUTO_BACKEND = "sym"


#: Elements of one block of a kernel's plain PyTorch version, by device
#: type: a (rows, N) block of ordered pair terms, or a batch of tile x tile
#: slots (larger blocks on the card cut launch overhead).
PLAIN_BLOCK_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}


def plain_block_elems(device) -> int:
    """PLAIN_BLOCK_ELEMS for a torch.device."""
    return PLAIN_BLOCK_ELEMS.get(device.type, 1 << 22)


def fast_rsqrt_cube(softening) -> bool:
    """Whether w = rsqrt((r2*r2)*r2) is safe: r2^3 must stay a normal fp32
    for the closest pairs, which holds whenever softening >= 1e-12."""
    return float(softening) >= 1e-12


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration for an N-body simulation.

    Attributes (as in the JAX ``SimConfig``; only the differences are
    noted here):
      backend: "auto", "torch", "direct", "sym" or "sym_mxu" (module
        docstring).
      tile_i: threads per block of the direct kernel; each block also
        stages its j-bodies through shared memory in tiles of this size.
        Must be a multiple of 8 (JAX rule); the CUDA kernel further needs a
        multiple of 32 up to 1024.
      tile_j: kept for parity with the JAX config (the Pallas j-block); the
        CUDA direct kernel stages j in tiles of ``tile_i``.
      sym_tile / sym_chunk: tile (64 or 128 on CUDA) and chunk of the sym
        and sym_mxu kernels; None = their defaults (128, 131072).
      traversal: "auto" or "slots" (the band traversal is not ported).
      fused_integrate: the fused force + Euler kernel; JAX's rule holds
        (integrator "euler", backend "direct", one card).
      mesh_shape, comm, resident: not ported; only their defaults are
        accepted.
    """

    n: int
    dt: float = DT
    steps: int = 10
    softening: float = SOFTENING
    integrator: str = "euler"
    backend: str = "auto"
    tile_i: int = 512
    tile_j: int = 2048
    sym_tile: Optional[int] = None
    sym_chunk: Optional[int] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    comm: str = "all_gather"
    use_masses: bool = False
    fused_integrate: bool = False
    split_w: bool = False
    resident: Optional[bool] = None
    coincident: str = "auto"
    traversal: str = "auto"

    def __post_init__(self):
        if self.n <= 0:
            raise ValueError(f"n must be positive, got {self.n}")
        if self.backend in _UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported yet "
                f"({_UNPORTED_BACKENDS[self.backend]})")
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.integrator not in _INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {_INTEGRATORS}, "
                f"got {self.integrator!r}")
        if self.traversal == "band":
            raise NotImplementedError(
                "traversal='band' is not ported yet (ROADMAP B16)")
        if self.traversal not in ("auto", "slots"):
            raise ValueError(
                f"traversal must be auto/slots, got {self.traversal!r}")
        check_coincident(self.coincident)
        if self.comm not in _COMMS:
            raise ValueError(
                f"comm must be one of {_COMMS}, got {self.comm!r}")
        if self.mesh_shape is not None or self.comm != "all_gather":
            raise NotImplementedError(
                "sharding (mesh_shape / comm) is not ported yet "
                "(ROADMAP A16)")
        if self.resident:
            raise NotImplementedError(
                "resident=True is not ported yet (ROADMAP B15)")
        if self.fused_integrate and (self.integrator != "euler"
                                     or self.backend != "direct"):
            raise ValueError(
                "fused_integrate requires integrator='euler', "
                "backend='direct', single card")
        if self.tile_i % 8 != 0:
            raise ValueError(
                f"tile_i must be a multiple of 8, got {self.tile_i}")
        if self.tile_j % 128 != 0:
            raise ValueError(
                f"tile_j must be a multiple of 128, got {self.tile_j}")

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        """Build from ``dataclasses.asdict(jax_cfg)``: maps the JAX backend
        names, drops ``interpret`` and accepts the unported JAX-only fields
        at their defaults only."""
        d = dict(d)
        d.pop("interpret", None)
        for key, default in (("pair_dtype", "float32"),
                             ("sym_bwd_tile", None),
                             ("resident_tile", None)):
            if d.pop(key, default) != default:
                raise NotImplementedError(
                    f"{key} is not ported yet (ROADMAP B6/B13/B15)")
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        backend = d.get("backend", "auto")
        if backend not in JAX_BACKENDS:
            raise ValueError(f"unknown JAX backend {backend!r}")
        d["backend"] = JAX_BACKENDS[backend]
        return cls(**d)

    def effective_backend(self) -> str:
        """The backend make_force_fn runs: 'auto' is AUTO_BACKEND."""
        return AUTO_BACKEND if self.backend == "auto" else self.backend

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m."""
    return -(-x // m) * m
