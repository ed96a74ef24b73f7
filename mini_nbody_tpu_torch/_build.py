"""Builds and loads the port's CUDA kernel library.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, never at import, and writes to ``build/mini_nbody_tpu_torch/`` next
to the package; the file name carries a hash of the sources, the headers
(``csrc/*.cuh``) and the flags, so a changed source builds a new library and
an unchanged one is reused.

Each C entry returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)

#: C signatures: name -> (argtypes, restype); every pointer and the stream
#: is a c_void_p, or ctypes would pass it as a 32-bit int; a long long is a
#: c_longlong.
SIGNATURES = {
    # pos_i, ni, pos_j, mass_j (or NULL), nj, out, softening, rsqrt form,
    # rows a thread, rows a CTA, stream
    "direct_force_launch": ([_P, _I, _P, _P, _I, _P, _F, _I, _I, _I, _P],
                            _I),
    # pos, vel, mass (or NULL), n, pos_out, vel_out, softening, dt, rsqrt
    # form, rows a thread, rows a CTA, stream
    "direct_euler_launch": ([_P, _P, _P, _I, _P, _P, _F, _F, _I, _I, _I,
                             _P], _I),
    # slots, n_slots, n_sys, sys_rows, pos_a, pos_b, v_a, v_b, part, tile,
    # softening, fast, split_w, mask_offdiag, stream
    "slot_pipe_launch": ([_P, _I, _I, _L, _P, _P, _P, _P, _P, _I, _F, _I, _I,
                          _I, _P], _I),
    # slots, n_slots, n_sys, sys_rows, pos_a, pos_b, part, k, tile,
    # softening, fast, stream
    "symmetric_force_launch": ([_P, _I, _I, _L, _P, _P, _P, _I, _I, _F, _I,
                                _P], _I),
    # pos_a, pos_b, v_a, v_b, rows, part, nb, i0, n_rows, cross, n_sys,
    # sys_rows, tile, softening, fast, split_w, mask_offdiag, stream
    "band_mxu_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I,
                         _F, _I, _I, _I, _P], _I),
    # part, tile_elems, n_targets, targets, offsets, entries, order, acc_a,
    # acc_b, n_sys, sys_acc_stride, sys_part_tiles, stream
    "slot_reduce_launch": ([_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _L, _L,
                            _P], _I),
    # pos, mass (or NULL), n, rows, softening, normal, rows a thread, rows
    # a CTA, stream
    "pe_rows_launch": ([_P, _P, _I, _P, _F, _I, _I, _I, _P], _I),
    # pos_k, g_k, mass_k (or NULL), nk, pos_j, g_j, mass_j (or NULL), nj,
    # out, softening, overlap_only, block, stream
    "vjp_ordered_launch": ([_P, _P, _P, _I, _P, _P, _P, _I, _P, _F, _I, _I,
                            _P], _I),
    # slots, n_slots, pos_a, g_a, pos_b, part, k, softening, stream
    "vjp_pair_launch": ([_P, _I, _P, _P, _P, _P, _I, _F, _P], _I),
    # slots, n_slots, n_sys, sys_rows, pos_a, pos_b, g_a, g_b, part, k, ko,
    # tile, softening, mask_offdiag, stream
    "vjp_sym_launch": ([_P, _I, _I, _L, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                        _I, _P], _I),
    # slots, n_slots, n_sys, sys_rows, pos_a, pos_b, g_a, g_b, q_a, q_b, part,
    # masses, ko, tile, softening, mask_offdiag, stream
    "vjp_mxu_launch": ([_P, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                        _I, _F, _I, _P], _I),
    # pos_k, g_k, nk, pos_j, g_j, nj, rows, masses, tile, softening,
    # overlap_only, stream
    "vjp_rect_mxu_launch": ([_P, _P, _I, _P, _P, _I, _P, _I, _I, _F, _I, _P],
                            _I),
    # pos_i, ni, pos_j, mass_j (or NULL), nj, out, sums (or NULL), softening,
    # overlap_only, bf16, stream
    "mxu_force_launch": ([_P, _I, _P, _P, _I, _P, _P, _F, _I, _I, _P], _I),
    # slots, pieces, n_pieces, targets, entries, last_target, largest,
    # pos_in, vel_in, mass_in (or NULL), pos_out, vel_out, pos, vel, q (or
    # NULL), acc (or NULL), part, bar, n_sys, np, n_real, steps, ends, dt,
    # softening, far, fast, mask_offdiag, coef (11 host floats or NULL),
    # y4_phase, tile, mxu, k, stream
    "resident_sym_launch": ([_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _F,
                             _F, _F, _I, _I, _P, _I, _I, _I, _I, _P], _I),
    # tile, mxu, k, fast, wide, out (3 ints: registers, local bytes, CTAs
    # per SM)
    "resident_sym_info": ([_I, _I, _I, _I, _I, _P], _I),
    # k, tile, fast, out (3 ints: registers, local bytes, CTAs per SM)
    "symmetric_force_info": ([_I, _I, _I, _P], _I),
    # tile, split_w, out (as above)
    "slot_pipe_info": ([_I, _I, _P], _I),
    # bf16, masses, out (as above)
    "mxu_force_info": ([_I, _I, _P], _I),
    # tile, split_w, fast, out (as above)
    "band_mxu_info": ([_I, _I, _I, _P], _I),
    # tile, masses, out (4 ints: as above, then threads per CTA)
    "vjp_rect_mxu_info": ([_I, _I, _P], _I),
    # rows a thread, rows a CTA, masses, rsqrt form, euler, out (4 ints:
    # registers, local bytes, CTAs per SM, threads per CTA): K1's or K5's
    # kernel
    "direct_force_info": ([_I, _I, _I, _I, _I, _P], _I),
    # rows a thread, rows a CTA, normal, out (4 ints, as above): K4's kernel
    "pe_rows_info": ([_I, _I, _I, _P], _I),
    # block, masses, out (4 ints: registers, local bytes, CTAs per SM,
    # threads per CTA): B10's kernel
    "vjp_ordered_info": ([_I, _I, _P], _I),
    # masses, out (4 ints, as above): B12's kernel (tile 128)
    "vjp_pair_info": ([_I, _P], _I),
    # tile, masses, ko, out (4 ints: registers, local bytes, CTAs per SM,
    # threads per CTA): B11's kernel, then B13's
    "vjp_sym_info": ([_I, _I, _I, _P], _I),
    "vjp_mxu_info": ([_I, _I, _I, _P], _I),
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
    for src in sources + sorted(CSRC.glob("*.cuh")):
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


def ptxas_report(log: str) -> dict:
    """{kernel's mangled name: {"registers", "spill_stores", "spill_loads"}}
    from nvcc's ptxas output (BUILD_LOG)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if name is not None and m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if name is not None and m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


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


def on_card(device) -> bool:
    """Whether tensors on ``device`` launch the kernels: True on a CUDA
    device, False on the CPU (each kernel's plain version); raises on any
    other device."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if a kernel is asked for a result autograd would have to
    differentiate: a kernel's output has no autograd history, so handing
    it back would silently cut the gradient."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and a CUDA kernel's output has "
            "no autograd history; differentiate through "
            "mini_nbody_tpu_torch.ops.autodiff.make_differentiable_force "
            "(or make_step_fn(cfg, differentiable=True)), or run under "
            "torch.no_grad()")


def stream_ptr(device) -> int:
    """The current stream of a CUDA device as a pointer, without building a
    torch Stream object (a few microseconds a launch)."""
    import torch

    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
