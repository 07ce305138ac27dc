"""Build the CUDA kernel libraries with nvcc at first use and load them
with ctypes.

Nine sources in ten translation units, each its own shared object,
compiled side by side (one nvcc process each, started together):
kernels/csrc/collide_stream.cu (the collide-stream kernel in its 18
collision-branch instances, each with and without the z planes' code,
a thread a cell of the box, and the moments kernel on fp32 state),
kernels/csrc/collide_stream_list.cu (the 18 branches of the fp32 step
over a vessel's fluid cells, each with the z planes' code,
collide_stream_list.cuh: a thread a lane of sector-aligned segments of
each row's fluid runs, its wall links in a word), kernels/csrc/collide_stream_bf16.cu
(the same on bf16 state as the paired kernel, a thread a pair of z
neighbours: 14 branches, no force field),
kernels/csrc/collide_stream2.cu and collide_stream2_bf16.cu (the fused
pair of steps, an x-marching column, in its 14 instances and the chunked
state read, on fp32 and on bf16 state), kernels/csrc/collide_stream_halo.cu (the sharded
collide-stream step, 14 branches with and without z planes, over the
box and over the shard's fluid cells, built twice:
with -DLBM_HALO_AXIS=0 for shards of a box split along x, =1 along y)
kernels/csrc/scalar_stream.cu (the D3Q7 scalar kernel in its 8
instances and its record reduction), kernels/csrc/windkessel.cu (the
collide-stream step with the windkessel outlets' flux folded in, its 14
instances and its reduction on fp32 state, and the flux kernel that
primes the fold on fp32 and bf16 state) and windkessel_bf16.cu (the
fold's 14 instances on bf16 state), for sm_90a with a
plain C interface (no PyTorch headers, so nvcc takes seconds). A source
and its bf16 twin instantiate one body header (collide_stream.cuh,
collide_stream2.cuh, windkessel.cuh) with the storage type; the bodies share the device
functions of kernels/csrc/d3q19.cuh. The bf16 entry points carry the
fp32 ones' names with _bf16 appended. The objects land in
kernels/_build/ under names that carry a hash of the source, the headers
and the flags, so an edited source is rebuilt and a stale object is never
loaded. Pointers and the stream cross as ctypes.c_void_p; every entry
point returns cudaGetLastError(). Processes that load at once (the ranks
of a sharded run) take turns on a file lock in kernels/_build/, so one
builds and the others load what it built.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
SOURCE = CSRC / "collide_stream.cu"
LIST_SOURCE = CSRC / "collide_stream_list.cu"
BF16_SOURCE = CSRC / "collide_stream_bf16.cu"
SCALAR_SOURCE = CSRC / "scalar_stream.cu"
PAIR_SOURCE = CSRC / "collide_stream2.cu"
PAIR_BF16_SOURCE = CSRC / "collide_stream2_bf16.cu"
HALO_SOURCE = CSRC / "collide_stream_halo.cu"
WK_SOURCE = CSRC / "windkessel.cu"
WK_BF16_SOURCE = CSRC / "windkessel_bf16.cu"
# the D3Q19 device functions, descriptors and their enums, shared by the
# single-step and the fused-pair sources
HEADER = CSRC / "d3q19.cuh"
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


def _declare(lib: ctypes.CDLL, sfx: str = "") -> None:
    """Declare the single-step library's entry points; sfx: "_bf16" for
    the bf16 library's."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lbm_block_size.argtypes = []
    lib.lbm_block_size.restype = ci
    lib.lbm_error_string.argtypes = [ci]
    lib.lbm_error_string.restype = ctypes.c_char_p
    step, macro = (getattr(lib, f"lbm_{n}{sfx}") for n in (
        "collide_stream", "macro"))
    step.argtypes = [
        vp, vp, vp,             # src, dst, mask
        ci, ci, ci,             # nx, ny, nz
        vp, vp,                 # collision int row, float row
        ci, vp, vp, vp, vp,     # n_bc, bc_int, bc_float, valid, phi_star
        # bf16: the launch list, its length, its pairs, the box's
        # interior bits, the box form
        *([vp, ci, ci, vp, ci] if sfx else []),
        vp, ci,                 # partials, n_partials
        vp, ci,                 # series, t
        vp,                     # g of a field force, or null
        vp,                     # stream
    ]
    step.restype = ci
    # f, rho, u, n_cells, half_force (host 3 floats or null), stream
    macro.argtypes = [vp, vp, vp, ctypes.c_longlong, vp, vp]
    macro.restype = ci
    if sfx == "_bf16":
        # b, (2,) uint64 counts on the device, stream
        lib.lbm_div_exact_check.argtypes = [ctypes.c_float, vp, vp]
        lib.lbm_div_exact_check.restype = ci


def _list_args(tail: list) -> list:
    """The argument types of a launch over the fluid cells (engine/compile
    .FluidLaunch), then `tail` and the stream."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return [
        vp, vp,                 # src, dst
        ci, ci, ci,             # nx, ny, nz
        vp, vp,                 # collision int row, float row
        ci, vp, vp, vp, vp,     # n_bc, bc_int, bc_float, valid, phi_star
        vp, vp, vp, ci,         # segs, links, moving or null, n_segs
        vp, ci,                 # partials, n_partials
        vp, ci,                 # series, t
        *tail,
        vp,                     # stream
    ]


def _declare_list(lib: ctypes.CDLL) -> None:
    """Declare the fp32 step over the fluid cells: lbm_collide_stream's
    arguments with the launch tables in place of the mask."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lbm_list_block_size.argtypes = []
    lib.lbm_list_block_size.restype = ci
    lib.lbm_error_string.argtypes = [ci]
    lib.lbm_error_string.restype = ctypes.c_char_p
    lib.lbm_collide_stream_list.argtypes = _list_args([vp])  # g or null
    lib.lbm_collide_stream_list.restype = ci


def _declare_halo(lib: ctypes.CDLL) -> None:
    """Declare the sharded step's entry points: lbm_collide_stream's
    arguments without the field force, plus the halo axis and planes, and
    the same over the shard's fluid cells (lbm_collide_stream_list's
    arguments without the field force, plus the halo)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lbm_block_size.argtypes = []
    lib.lbm_block_size.restype = ci
    lib.lbm_error_string.argtypes = [ci]
    lib.lbm_error_string.restype = ctypes.c_char_p
    halo = [ci, vp, vp, vp, vp]  # axis, lo, hi, mask_lo, mask_hi
    lib.lbm_list_block_size.argtypes = []
    lib.lbm_list_block_size.restype = ci
    lib.lbm_collide_stream_halo_list.argtypes = _list_args(halo)
    lib.lbm_collide_stream_halo_list.restype = ci
    lib.lbm_collide_stream_halo.argtypes = [
        vp, vp, vp,             # src, dst, mask
        ci, ci, ci,             # nx, ny, nz
        vp, vp,                 # collision int row, float row
        ci, vp, vp, vp, vp,     # n_bc, bc_int, bc_float, valid, phi_star
        vp, ci,                 # partials, n_partials
        vp, ci,                 # series, t
        *halo,
        vp,                     # stream
    ]
    lib.lbm_collide_stream_halo.restype = ci


def _declare_scalar(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lbm_scalar_block_size.argtypes = []
    lib.lbm_scalar_block_size.restype = ci
    lib.lbm_error_string.argtypes = [ci]
    lib.lbm_error_string.restype = ctypes.c_char_p
    lib.lbm_scalar_stream.argtypes = [
        vp, vp, vp,             # src, dst, mask
        ci, ci, ci,             # nx, ny, nz
        vp, vp, vp, vp,         # u, f, comp, wall_c
        vp, vp,                 # parameter int row, float row
        ci, vp, vp, vp, vp,     # n_bc, bc_int, bc_float, valid, cplane
        vp, vp,                 # footprint list, its offsets (host)
        vp, ci,                 # cell list or null, its length
        vp,                     # record row, or null
        vp,                     # stream
    ]
    lib.lbm_scalar_stream.restype = ci


def _declare_wk(lib: ctypes.CDLL, sfx: str = "") -> None:
    """Declare a windkessel library's entry points: the fold step (sfx
    "_bf16" for the bf16 library's) and, in the fp32 library, the flux
    kernel that primes it on either storage."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lbm_block_size.argtypes = []
    lib.lbm_block_size.restype = ci
    lib.lbm_error_string.argtypes = [ci]
    lib.lbm_error_string.restype = ctypes.c_char_p
    fold = getattr(lib, f"lbm_collide_stream_wk{sfx}")
    fold.argtypes = [
        vp, vp, vp,             # src, dst, mask
        ci, ci, ci,             # nx, ny, nz
        vp, vp,                 # collision int row, float row
        ci, vp, vp, vp, vp,     # n_bc, bc_int, bc_float, valid, phi_star
        vp,                     # each row's outlet or -1 (host ints)
        vp, ci,                 # fluid-cell list, its length
        vp, ci,                 # partials, n_partials
        vp, ci,                 # series, t
        ci, vp, vp,             # n_wk, int rows, float rows (host)
        vp, vp, ci,             # footprint weights, codes, n_foot
        vp, vp, vp,             # terms, Q staged, P_c (in place)
        vp,                     # stream
    ]
    fold.restype = ci
    if sfx:
        return
    lib.lbm_windkessel_block_size.argtypes = []
    lib.lbm_windkessel_block_size.restype = ci
    lib.lbm_windkessel_max.argtypes = []
    lib.lbm_windkessel_max.restype = ci
    for name in ("lbm_windkessel_flux", "lbm_windkessel_flux_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [
            vp, ctypes.c_longlong,  # src, n_cells
            ci, vp, vp,             # n_wk, int rows, float rows (host)
            vp,                     # half force (host 3 floats) or null
            vp, vp,                 # footprint cells, weights
            vp, vp,                 # terms, Q staged
            vp,                     # stream
        ]
        fn.restype = ci


def _declare_pair(lib: ctypes.CDLL, sfx: str = "") -> None:
    """Declare the fused-pair library's entry points; sfx as in
    _declare."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lbm_pair_unit.argtypes = [ci]  # axis -> the unit's extent
    lib.lbm_pair_unit.restype = ci
    lib.lbm_pair_block_size.argtypes = []
    lib.lbm_pair_block_size.restype = ci
    lib.lbm_pair_blocks_per_sm.argtypes = [ci]  # instance key
    lib.lbm_pair_blocks_per_sm.restype = ci
    lib.lbm_pair_smem_bytes.argtypes = []
    lib.lbm_pair_smem_bytes.restype = ctypes.c_longlong
    lib.lbm_error_string.argtypes = [ci]
    lib.lbm_error_string.restype = ctypes.c_char_p
    pair, rows = (getattr(lib, f"lbm_{n}{sfx}") for n in (
        "collide_stream2", "extract_rows"))
    pair.argtypes = [
        vp, vp, vp,             # src, dst, mask
        ci, ci, ci,             # nx, ny, nz
        vp, vp,                 # collision int row, float row
        ci, vp, vp, vp,         # n_bc, bc_int, bc_float, valid
        vp, vp,                 # phi_star of step t, of step t + 1
        vp, ci,                 # units, n_units
        vp, ci,                 # partials, n_partials
        vp, ci,                 # series, slot
        vp,                     # stream
    ]
    pair.restype = ci
    # f, out, X, Y, Z, x0, wx, stream
    rows.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp]
    rows.restype = ci


# name -> (source, declare, extra nvcc flags)
_SOURCES = {
    "collide_stream": (SOURCE, _declare, ()),
    "collide_stream_list": (LIST_SOURCE, _declare_list, ()),
    "collide_stream_bf16": (BF16_SOURCE,
                            functools.partial(_declare, sfx="_bf16"), ()),
    "collide_stream2": (PAIR_SOURCE, _declare_pair, ()),
    "collide_stream2_bf16": (PAIR_BF16_SOURCE,
                             functools.partial(_declare_pair, sfx="_bf16"),
                             ()),
    "collide_stream_halo_x": (HALO_SOURCE, _declare_halo,
                              ("-DLBM_HALO_AXIS=0",)),
    "collide_stream_halo_y": (HALO_SOURCE, _declare_halo,
                              ("-DLBM_HALO_AXIS=1",)),
    "scalar_stream": (SCALAR_SOURCE, _declare_scalar, ()),
    "windkessel": (WK_SOURCE, _declare_wk, ()),
    "windkessel_bf16": (WK_BF16_SOURCE,
                        functools.partial(_declare_wk, sfx="_bf16"), ()),
}


def _object_path(name: str) -> Path:
    source, _, extra = _SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(
        source.parent.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + extra)
    digest = hashlib.sha256(source.read_bytes() + headers
                            + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on kernels/_build/.lock for the calling process,
    held while it builds (other processes wait, then find the objects)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


@functools.lru_cache(maxsize=None)
def _load_all() -> dict:
    """Build what is missing, one nvcc per source and all started
    together, then load every library: {name: Library}, once per
    process."""
    with _build_lock():
        built = _build_missing()
    out = {}
    for name, (_, declare, _) in _SOURCES.items():
        so = _object_path(name)
        lib = ctypes.CDLL(str(so))
        declare(lib)
        seconds, log = built.get(name, (0.0, ""))
        out[name] = Library(lib=lib, path=so, built=name in built,
                            build_seconds=seconds, log=log)
    return out


def _build_missing() -> dict:
    """nvcc every source whose object is missing, side by side: {name:
    (seconds, log)} of those built."""
    jobs = {}
    for name, (source, _, extra) in _SOURCES.items():
        so = _object_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        jobs[name] = ([nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp,
                       str(source)], tmp, so)

    def compile_one(cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc, time.perf_counter() - t0

    built = {}
    failure = None
    with concurrent.futures.ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        runs = {name: pool.submit(compile_one, job[0])
                for name, job in jobs.items()}
    for name, (cmd, tmp, so) in jobs.items():
        proc, seconds = runs[name].result()
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            failure = failure or RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
        built[name] = (seconds, log)
    if failure is not None:
        raise failure
    return built


def load_library(bf16: bool = False) -> Library:
    """The collide-stream library, of bf16 state with bf16 (built with
    the others if needed)."""
    return _load_all()["collide_stream_bf16" if bf16 else "collide_stream"]


def load_list_library() -> Library:
    """The fp32 collide-stream library of the launch over the fluid cells
    (built with the others if needed)."""
    return _load_all()["collide_stream_list"]


def load_pair_library(bf16: bool = False) -> Library:
    """The fused-pair and row-extract library, of bf16 state with bf16
    (built with the others if needed)."""
    return _load_all()["collide_stream2_bf16" if bf16
                       else "collide_stream2"]


def load_halo_library(axis: int) -> Library:
    """The sharded collide-stream library of shards split along x (axis
    0) or y (1) (built with the others if needed)."""
    return _load_all()[("collide_stream_halo_x", "collide_stream_halo_y")
                       [axis]]


def load_scalar_library() -> Library:
    """The D3Q7 scalar library (built with the others if needed)."""
    return _load_all()["scalar_stream"]


def load_wk_library(bf16: bool = False) -> Library:
    """The windkessel library (the fold step and the flux kernel), of the
    fold on bf16 state with bf16 (built with the others if needed)."""
    return _load_all()["windkessel_bf16" if bf16 else "windkessel"]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.lbm_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


__all__ = ["Library", "load_library", "load_list_library",
           "load_pair_library",
           "load_halo_library", "load_scalar_library", "load_wk_library",
           "check", "nvcc_path",
           "SOURCE", "LIST_SOURCE", "BF16_SOURCE", "PAIR_SOURCE",
           "PAIR_BF16_SOURCE",
           "HALO_SOURCE", "SCALAR_SOURCE", "WK_SOURCE", "WK_BF16_SOURCE",
           "HEADER",
           "BUILD_DIR",
           "NVCC_FLAGS"]
