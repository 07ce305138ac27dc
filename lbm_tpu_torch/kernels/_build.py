"""Build the CUDA kernel library with nvcc at first use and load it with
ctypes.

The library is kernels/csrc/collide_stream.cu compiled for sm_90a into a
shared object with a plain C interface (no PyTorch headers, so nvcc
takes seconds). It lands in kernels/_build/ under a name that carries a
hash of the source and flags, so an edited source is rebuilt and a
stale object is never loaded. Pointers and the stream cross as
ctypes.c_void_p; every entry point returns cudaGetLastError().
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SOURCE = Path(__file__).parent / "csrc" / "collide_stream.cu"
BUILD_DIR = Path(__file__).parent / "_build"
# -fmad=false: no multiply-add contraction, so the kernels round exactly
# like their plain PyTorch versions and the collide-stream kernel is bit
# for bit the dense step. With contraction the lid 64^3 cavity drifts to
# a relative L2 of 9.8e-6 in u after 200 steps, for a step 0.8% shorter
# at 256^3 (H100 80GB HBM3 at 700 W; PERF.md).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    built: bool            # False when a matching object was already there
    build_seconds: float   # nvcc wall time (0.0 when not built)
    log: str               # nvcc's output (ptxas register/spill report)


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels build from source at first use")


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lbm_block_size.argtypes = []
    lib.lbm_block_size.restype = ci
    lib.lbm_error_string.argtypes = [ci]
    lib.lbm_error_string.restype = ctypes.c_char_p
    lib.lbm_collide_stream_bgk.argtypes = [
        vp, vp, vp,             # src, dst, mask
        ci, ci, ci,             # nx, ny, nz
        ctypes.c_float,         # tau
        ci, vp, vp, vp, vp,     # n_bc, bc_int, bc_float, valid, phi_star
        vp, ci,                 # partials, n_partials
        vp, ci,                 # series, t
        vp,                     # stream
    ]
    lib.lbm_collide_stream_bgk.restype = ci
    lib.lbm_macro.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
    lib.lbm_macro.restype = ci


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library, once per process."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libcollide_stream_{digest[:16]}.so"
    built, seconds, log = False, 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
        built = True
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    return Library(lib=lib, path=so, built=built, build_seconds=seconds,
                   log=log)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.lbm_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


__all__ = ["Library", "load_library", "check", "nvcc_path", "SOURCE",
           "BUILD_DIR", "NVCC_FLAGS"]
