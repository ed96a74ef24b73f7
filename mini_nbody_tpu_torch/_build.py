"""Builds and loads the port's CUDA kernel library.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one shared
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
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "mini_nbody_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C signatures: name -> (argtypes, restype); every pointer and the stream
#: is a c_void_p, or ctypes would pass it as a 32-bit int.
SIGNATURES = {
    # pos_i, ni, pos_j, mass_j (or NULL), nj, out, softening, fast, block,
    # stream
    "direct_force_launch": ([_P, _I, _P, _P, _I, _P, _F, _I, _I, _P], _I),
    # pos, vel, mass (or NULL), n, pos_out, vel_out, softening, dt, fast,
    # block, stream
    "direct_euler_launch": ([_P, _P, _P, _I, _P, _P, _F, _F, _I, _I, _P],
                            _I),
    # slots, n_slots, pos_a, pos_b, v_a, v_b, acc_a, acc_b, tile, softening,
    # fast, split_w, mask_offdiag, stream
    "slot_pipe_launch": ([_P, _I, _P, _P, _P, _P, _P, _P, _I, _F, _I, _I,
                          _I, _P], _I),
    # slots, n_slots, pos_a, pos_b, acc_a, acc_b, k, tile, softening, fast,
    # stream
    "symmetric_force_launch": ([_P, _I, _P, _P, _P, _P, _I, _I, _F, _I, _P],
                               _I),
    # pos, mass (or NULL), n, rows, softening, block, stream
    "pe_rows_launch": ([_P, _P, _I, _P, _F, _I, _P], _I),
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


def _compile_and_link(sources, tmp: Path, lib_path: Path) -> str:
    """One nvcc per source, all running at once, then one link; returns
    nvcc's output (the ptxas report) and raises if any step fails."""
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = tmp / f"{src.stem}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(log))
    lib_tmp = tmp / lib_path.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
         *(str(obj) for _, obj, _ in procs)],
        capture_output=True, text=True)
    log.append(link.stdout + link.stderr)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "".join(log))
    os.replace(lib_tmp, lib_path)
    return "".join(log)


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
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            BUILD_LOG = _compile_and_link(sources, Path(tmp), lib_path)
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
