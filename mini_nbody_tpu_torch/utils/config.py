"""Simulation configuration for the PyTorch port.

Counterpart of ``mini_nbody_tpu/utils/config.py:18-287``: the same physical
constants and the same frozen ``SimConfig`` with the same validation, cut to
the fields the port honours. ``interpret`` is gone: there is no
interpreter, a tensor on the CPU takes each kernel's plain PyTorch version
and a tensor on the card takes the kernel.

Backend names follow PyTorch rather than JAX: ``"torch"`` is the plain
all-pairs op (JAX ``"jnp"``), ``"direct"`` the hand-written ordered kernel
(JAX ``"pallas"``), ``"sym"`` the fp32 pair-once kernel, ``"sym_mxu"`` the
pair-once tensor-core kernel, ``"mxu"`` the ordered tensor-core hybrid (its
precision class set by ``pair_dtype``), and ``"auto"`` resolves to ``"sym"``
on every device, as JAX's single-chip ``auto`` does
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

_BACKENDS = ("auto", "torch", "direct", "sym", "sym_mxu", "mxu")
#: JAX backend names -> port backend names (SimConfig.from_dict).
JAX_BACKENDS = {"auto": "auto", "jnp": "torch", "pallas": "direct",
                "sym_mxu": "sym_mxu", "sym": "sym", "mxu": "mxu"}
_INTEGRATORS = ("euler", "leapfrog", "rk4", "yoshida4")
#: Precision of the mxu backend's accumulation products (JAX's names).
_PAIR_DTYPES = ("float32", "bfloat16")
_COMMS = ("all_gather", "ring", "ring_sym", "grid")

COINCIDENT_MODES = ("auto", "masked", "fast")


def check_coincident(value: str) -> str:
    """Validate a coincident-mode flag."""
    if value not in COINCIDENT_MODES:
        raise ValueError(
            f"coincident must be one of {COINCIDENT_MODES}, got {value!r}")
    return value


#: Tiles the CUDA pair-once backward kernels are built for.
SYM_BWD_TILES = (64, 128)

#: Tiles the CUDA resident kernel (B15) is built for.
RESIDENT_TILES = (64, 128)

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
      backend: "auto", "torch", "direct", "sym", "sym_mxu" or "mxu" (module
        docstring).
      pair_dtype: the mxu backend's product precision, as in JAX:
        "float32" (the default, the fp32-exact class) or "bfloat16" (the
        bf16-accumulate class). Other backends ignore it.
      tile_i: threads per block of the direct kernel; each block also
        stages its j-bodies through shared memory in tiles of this size.
        Must be a multiple of 8 (JAX rule); the CUDA kernel further needs a
        multiple of 32 up to 1024. Also the i tile of the mxu backend's
        plain version (CPU tensors).
      tile_j: the j tile of the mxu backend's plain version, as the Pallas
        j-block; the CUDA direct kernel stages j in tiles of ``tile_i``,
        and the mxu kernel (B6) has tiles of its own.
      sym_tile / sym_chunk: tile (64 or 128 on CUDA) and chunk of the sym
        and sym_mxu kernels; None = their defaults (128, 131072).
      sym_bwd_tile: tile of the pair-once backward kernels (vjp_pos_sym,
        vjp_pos_sym_mxu): None (their defaults, 64 and 128) or one of
        SYM_BWD_TILES, the tiles the CUDA kernels are built for. JAX's
        VMEM-sized tiles (640, 768) are refused.
      traversal: "auto" or "slots" (the slot list) or "band" (the band
        traversal, B16), as in JAX; backend "sym_mxu" honours it, "sym"
        refuses "band" (ops/force.py), and the resident route and the
        sharded path's self kernels run the slots whatever it says.
      fused_integrate: the fused force + Euler kernel; JAX's rule holds
        (integrator "euler", backend "direct", one card).
      resident: the whole-trajectory resident kernel (ops/resident_sym.py,
        B15): True forces it (JAX's rules: one card, no fused_integrate, no
        split_w, integrator euler, leapfrog or yoshida4, a symmetric-class
        backend), False pins the streamed path, None routes by the card's
        crossovers (sim.py).
      resident_tile: the resident kernel's tile: None (its default) or one
        of RESIDENT_TILES, the tiles the CUDA kernel is built for.
      mesh_shape, comm: the mesh and exchange of the sharded path
        (``parallel/sharded.py``), JAX's rules: 'grid' needs a 2-D
        mesh_shape and every other comm a 1-D one; fused_integrate and
        resident=True need mesh_shape=None.
    """

    n: int
    dt: float = DT
    steps: int = 10
    softening: float = SOFTENING
    integrator: str = "euler"
    backend: str = "auto"
    pair_dtype: str = "float32"
    tile_i: int = 512
    tile_j: int = 2048
    sym_tile: Optional[int] = None
    sym_chunk: Optional[int] = None
    sym_bwd_tile: Optional[int] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    comm: str = "all_gather"
    use_masses: bool = False
    fused_integrate: bool = False
    split_w: bool = False
    resident: Optional[bool] = None
    resident_tile: Optional[int] = None
    coincident: str = "auto"
    traversal: str = "auto"

    def __post_init__(self):
        if self.n <= 0:
            raise ValueError(f"n must be positive, got {self.n}")
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.integrator not in _INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {_INTEGRATORS}, "
                f"got {self.integrator!r}")
        if self.pair_dtype not in _PAIR_DTYPES:
            raise ValueError(f"pair_dtype must be one of {_PAIR_DTYPES}, "
                             f"got {self.pair_dtype!r}")
        if self.traversal not in ("auto", "slots", "band"):
            raise ValueError(
                f"traversal must be auto/slots/band, got {self.traversal!r}")
        check_coincident(self.coincident)
        if self.comm not in _COMMS:
            raise ValueError(
                f"comm must be one of {_COMMS}, got {self.comm!r}")
        if self.mesh_shape is not None:
            want = 2 if self.comm == "grid" else 1
            if len(self.mesh_shape) != want:
                raise ValueError(
                    f"comm {self.comm!r} needs a {want}-D mesh_shape, got "
                    f"{self.mesh_shape}")
        if self.resident:
            if self.mesh_shape is not None or self.fused_integrate:
                raise ValueError(
                    "resident=True needs a single card and no "
                    "fused_integrate (the resident kernel fuses its own)")
            if self.integrator not in ("euler", "leapfrog", "yoshida4"):
                raise ValueError(
                    "resident=True supports integrator 'euler', 'leapfrog' "
                    f"or 'yoshida4', got {self.integrator!r}")
            if self.split_w:
                raise ValueError(
                    "resident=True has no split_w accuracy mode (the "
                    "resident kernel runs the plain compensated operand "
                    "split); use the streamed path for split_w")
            if self.effective_backend() not in ("sym", "sym_mxu", "torch"):
                raise ValueError(
                    "resident=True requires a symmetric-class backend "
                    "('auto'/'sym'/'sym_mxu'), got "
                    f"{self.backend!r}")
        if self.resident_tile not in (None, *RESIDENT_TILES):
            raise ValueError(
                f"resident_tile must be None or one of {RESIDENT_TILES} (the "
                f"CUDA resident kernel's tiles), got {self.resident_tile}")
        if self.fused_integrate and (self.integrator != "euler"
                                     or self.backend != "direct"
                                     or self.mesh_shape is not None):
            raise ValueError(
                "fused_integrate requires integrator='euler', "
                "backend='direct', single card")
        if self.sym_bwd_tile not in (None, *SYM_BWD_TILES):
            raise ValueError(
                f"sym_bwd_tile must be None or one of {SYM_BWD_TILES} (the "
                f"CUDA backward kernels' tiles), got {self.sym_bwd_tile}")
        if self.tile_i % 8 != 0:
            raise ValueError(
                f"tile_i must be a multiple of 8, got {self.tile_i}")
        if self.tile_j % 128 != 0:
            raise ValueError(
                f"tile_j must be a multiple of 128, got {self.tile_j}")

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        """Build from ``dataclasses.asdict(jax_cfg)``: maps the JAX backend
        names and drops ``interpret``."""
        d = dict(d)
        d.pop("interpret", None)
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        backend = d.get("backend", "auto")
        if backend not in JAX_BACKENDS:
            raise ValueError(f"unknown JAX backend {backend!r}")
        d["backend"] = JAX_BACKENDS[backend]
        return cls(**d)

    def effective_backend(self, sharded: bool = False) -> str:
        """The backend make_force_fn runs: 'auto' is AUTO_BACKEND on one
        card and 'direct' under sharding, where JAX's auto stays on its
        ordered kernel (``mini_nbody_tpu/utils/config.py:246-253``)."""
        if self.backend != "auto":
            return self.backend
        return "direct" if sharded else AUTO_BACKEND

    def bf16_class(self) -> bool:
        """True when the force path accumulates through bf16 tensor-core
        products: ``sym_mxu`` always, ``mxu`` with pair_dtype="bfloat16"
        (JAX's rule). Routes the backward: fp32 forwards keep fp32
        backwards."""
        eff = self.effective_backend()
        return eff == "sym_mxu" or (eff == "mxu"
                                    and self.pair_dtype == "bfloat16")

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m."""
    return -(-x // m) * m
