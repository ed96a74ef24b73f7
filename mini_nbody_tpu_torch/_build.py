"""Builds and loads the port's CUDA kernel library.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, never at import, and writes to ``build/mini_nbody_tpu_torch/`` next
to the package; the file name carries a hash of the sources and flags, so a
changed source builds a new library and an unchanged one is reused.

Each C entry returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "mini_nbody_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C signatures: name -> (argtypes, restype); every pointer and the stream
#: is a c_void_p, or ctypes would pass it as a 32-bit int.
SIGNATURES = {
    # pos_i, ni, pos_j, mass_j (or NULL), nj, out, softening, fast, block,
    # stream
    "direct_force_launch": ([_P, _I, _P, _P, _I, _P, _F, _I, _I, _P], _I),
    # slots, n_slots, pos_a, pos_b, v_a, v_b, acc_a, acc_b, tile, softening,
    # fast, split_w, mask_offdiag, stream
    "slot_pipe_launch": ([_P, _I, _P, _P, _P, _P, _P, _P, _I, _F, _I, _I,
                          _I, _P], _I),
    "nbody_error_string": ([_I], ctypes.c_char_p),
}

#: Seconds the last build took and nvcc's output (ptxas register and
#: shared-memory report); None when the library was already built.
BUILD_SECONDS = None
BUILD_LOG = ""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global BUILD_SECONDS, BUILD_LOG
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libnbody_kernels_{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, lib_path)
        BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        msg = lib.nbody_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_tensor(name, t, shape, dtype, device) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
