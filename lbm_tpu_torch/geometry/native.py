"""ctypes bindings for the native geometry runtime (csrc/lbm_geo.cpp) and
their NumPy plain versions (a jax-free copy of lbm_tpu/geometry/native.py):
  - vertex adjacency (smoothpatch/vertex_neighbours_double.c semantics)
  - inverse-distance and curvature(-cotangent) Laplacian mesh smoothing
    (smoothpatch_{inversedistance,curvature}_double.c semantics)
  - STL loading and voxelization (the geo_preprocess step: a Cartesian
    occupancy grid from a surface by parity ray casting)

The library is built with g++ ($CXX if set) at the first call that needs
it, never at import, into geometry/_build/ under a name that carries a
hash of the source, the compiler and the flags, behind a file lock:
processes that build at once take turns, and the later ones load what the
first built. A failed build raises with the compiler's output; nothing
falls back to NumPy without a word. The NumPy versions are the plain
versions, taken with native=False.

This is host code: NumPy and ctypes, no device.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).parent / "csrc" / "lbm_geo.cpp"
BUILD_DIR = Path(__file__).parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    built: bool            # False when a matching object was already there
    build_seconds: float   # the compiler's wall time (0.0 when not built)


_LIB: Library | None = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """Where the library of this source, compiler and flags lives."""
    key = SOURCE.read_bytes() + " ".join((compiler(),) + CXX_FLAGS).encode()
    return BUILD_DIR / f"liblbm_geo_{hashlib.sha256(key).hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _build(so: Path) -> float:
    """Compile SOURCE into `so`; the compiler's seconds. Raises
    RuntimeError with the command and the compiler's output if it fails."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(
            f"lbm_geo build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"lbm_geo build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    return time.perf_counter() - t0


def load() -> Library:
    """The native library, built first if its object is missing."""
    global _LIB
    so = library_path()
    if _LIB is not None and _LIB.path == so:
        return _LIB
    seconds, built = 0.0, False
    with _build_lock():
        if not so.exists():
            seconds, built = _build(so), True
    lib = ctypes.CDLL(str(so))
    i64, vp = ctypes.c_int64, ctypes.POINTER
    lib.build_adjacency.restype = i64
    lib.build_adjacency.argtypes = [vp(i64), i64, i64, vp(i64), vp(i64),
                                    ctypes.c_int]
    lib.smooth_mesh.restype = None
    lib.smooth_mesh.argtypes = [
        vp(ctypes.c_double), i64, vp(i64), i64,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
    ]
    lib.voxelize.restype = None
    lib.voxelize.argtypes = [
        vp(ctypes.c_double), i64, vp(ctypes.c_double), ctypes.c_double,
        i64, i64, i64, vp(ctypes.c_int32),
    ]
    _LIB = Library(lib=lib, path=so, built=built, build_seconds=seconds)
    return _LIB


def have_native() -> bool:
    """Whether the native library builds and loads."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


# ---------------------------------------------------------------------------
# Vertex adjacency
# ---------------------------------------------------------------------------

def vertex_neighbours(faces: np.ndarray, nv: int, native: bool = True):
    """CSR (offsets, neighbors) adjacency from an (nf, 3) face list."""
    faces = np.ascontiguousarray(faces, np.int64)
    if native:
        lib = load().lib
        total = lib.build_adjacency(
            _ptr(faces, ctypes.c_int64), len(faces), nv, None, None, 1
        )
        offsets = np.zeros(nv + 1, np.int64)
        neigh = np.zeros(total, np.int64)
        lib.build_adjacency(
            _ptr(faces, ctypes.c_int64), len(faces), nv,
            _ptr(offsets, ctypes.c_int64), _ptr(neigh, ctypes.c_int64), 0,
        )
        return offsets, neigh
    adj = [[] for _ in range(nv)]
    for a, b, c in faces:
        for u, v in ((a, b), (a, c), (b, a), (b, c), (c, a), (c, b)):
            if v not in adj[u]:
                adj[u].append(v)
    offsets = np.zeros(nv + 1, np.int64)
    flat = []
    for v in range(nv):
        offsets[v] = len(flat)
        flat.extend(adj[v])
    offsets[nv] = len(flat)
    return offsets, np.asarray(flat, np.int64)


# ---------------------------------------------------------------------------
# Mesh smoothing
# ---------------------------------------------------------------------------

def smooth_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    iterations: int = 10,
    mode: str = "inversedistance",
    sigma: float = 1e-6,
    lam: float = 0.5,
    native: bool = True,
) -> np.ndarray:
    """Iterative Laplacian smoothing; mode 'inversedistance' or 'curvature'
    (cotangent-flow). Returns new vertices (nv, 3)."""
    verts = np.ascontiguousarray(vertices, np.float64).copy()
    faces = np.ascontiguousarray(faces, np.int64)
    m = {"inversedistance": 0, "curvature": 1}[mode]
    if native:
        load().lib.smooth_mesh(
            _ptr(verts, ctypes.c_double), len(verts),
            _ptr(faces, ctypes.c_int64), len(faces),
            iterations, m, sigma, lam,
        )
        return verts
    # the plain version (vectorized edge scatter)
    nv = len(verts)
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [0, 2]], faces[:, [1, 0]],
         faces[:, [1, 2]], faces[:, [2, 0]], faces[:, [2, 1]]]
    )
    e = np.unique(e, axis=0)
    for _ in range(iterations):
        if m == 0:
            d = np.linalg.norm(verts[e[:, 1]] - verts[e[:, 0]], axis=1)
            w = 1.0 / (d + sigma)
        else:
            w = _cot_weights(verts, faces, e)
        acc = np.zeros_like(verts)
        ws = np.zeros(nv)
        np.add.at(acc, e[:, 0], w[:, None] * verts[e[:, 1]])
        np.add.at(ws, e[:, 0], w)
        ok = ws > 0
        target = np.where(ok[:, None], acc / np.maximum(ws, 1e-300)[:, None],
                          verts)
        verts = (1 - lam) * verts + lam * target
    return verts


def _cot_weights(verts, faces, edges):
    key = {tuple(k): i for i, k in enumerate(map(tuple, edges))}
    w = np.zeros(len(edges))
    for f in faces:
        for corner in range(3):
            o, a, b = f[corner], f[(corner + 1) % 3], f[(corner + 2) % 3]
            u = verts[a] - verts[o]
            v = verts[b] - verts[o]
            cot = max(np.dot(u, v) / (np.linalg.norm(np.cross(u, v)) + 1e-12),
                      0.0)
            w[key[(a, b)]] += cot
            w[key[(b, a)]] += cot
    return w


# ---------------------------------------------------------------------------
# STL loading + voxelization
# ---------------------------------------------------------------------------

def load_stl(path: str) -> np.ndarray:
    """Triangles (ntri, 3, 3) from binary or ASCII STL."""
    with open(path, "rb") as fh:
        head = fh.read(5)
    if head.lower() == b"solid":
        # Could still be binary with a 'solid' header; try ASCII first.
        try:
            return _load_stl_ascii(path)
        except ValueError:
            pass
    return _load_stl_binary(path)


def _load_stl_binary(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        fh.seek(80)
        (ntri,) = np.frombuffer(fh.read(4), np.uint32)
        data = np.frombuffer(fh.read(int(ntri) * 50), np.uint8)
    rec = data.reshape(int(ntri), 50)
    floats = rec[:, :48].copy().view("<f4").reshape(int(ntri), 4, 3)
    return floats[:, 1:4].astype(np.float64)


def _load_stl_ascii(path: str) -> np.ndarray:
    tris, cur = [], []
    with open(path, "r", errors="strict") as fh:
        for line in fh:
            parts = line.split()
            if parts[:1] == ["vertex"]:
                cur.append([float(p) for p in parts[1:4]])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
    if not tris:
        raise ValueError("no ASCII facets found")
    return np.asarray(tris, np.float64)


def voxelize_mesh(
    tris: np.ndarray,
    shape: tuple[int, int, int],
    origin=None,
    spacing: float | None = None,
    margin: int = 2,
    native: bool = True,
) -> np.ndarray:
    """Binary occupancy (nx, ny, nz) from a watertight triangle surface by
    +z parity ray casting at cell centers. If origin/spacing are omitted
    the mesh is fitted into the grid with `margin` empty cells per side."""
    nx, ny, nz = shape
    tris = np.ascontiguousarray(tris, np.float64)
    lo = tris.reshape(-1, 3).min(axis=0)
    hi = tris.reshape(-1, 3).max(axis=0)
    if spacing is None:
        spacing = float(
            np.max((hi - lo) / (np.asarray(shape) - 2 * margin))
        )
    if origin is None:
        center = (lo + hi) / 2
        origin = center - np.asarray(shape) * spacing / 2
    origin = np.ascontiguousarray(origin, np.float64)
    if not native:
        return _voxelize_np(tris, origin, spacing, shape)
    out = np.zeros(nx * ny * nz, np.int32)
    load().lib.voxelize(
        _ptr(tris, ctypes.c_double), len(tris),
        _ptr(origin, ctypes.c_double), float(spacing),
        nx, ny, nz, _ptr(out, ctypes.c_int32),
    )
    return out.reshape(nx, ny, nz)


def _voxelize_np(tris, origin, spacing, shape):
    nx, ny, nz = shape
    px = origin[0] + (np.arange(nx) + 0.5) * spacing
    py = origin[1] + (np.arange(ny) + 0.5) * spacing
    pz = origin[2] + (np.arange(nz) + 0.5) * spacing
    out = np.zeros(shape, np.int32)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    d = (v1[:, 1] - v2[:, 1]) * (v0[:, 0] - v2[:, 0]) + (
        v2[:, 0] - v1[:, 0]
    ) * (v0[:, 1] - v2[:, 1])
    keep = np.abs(d) > 1e-30
    v0, v1, v2, d = v0[keep], v1[keep], v2[keep], d[keep]
    for i, x in enumerate(px):
        for j, y in enumerate(py):
            l0 = ((v1[:, 1] - v2[:, 1]) * (x - v2[:, 0])
                  + (v2[:, 0] - v1[:, 0]) * (y - v2[:, 1])) / d
            l1 = ((v2[:, 1] - v0[:, 1]) * (x - v2[:, 0])
                  + (v0[:, 0] - v2[:, 0]) * (y - v2[:, 1])) / d
            l2 = 1.0 - l0 - l1
            hit = (l0 >= 0) & (l1 >= 0) & (l2 > 0)
            if not hit.any():
                continue
            zhit = (l0[hit] * v0[hit, 2] + l1[hit] * v1[hit, 2]
                    + l2[hit] * v2[hit, 2])
            cnt = (zhit[None, :] > pz[:, None]).sum(axis=1)
            out[i, j] = cnt & 1
    return out


def fit_plane_normal(points: np.ndarray) -> np.ndarray:
    """Least-squares plane fit -> unit normal (the fitNormal/fitNormal.m
    capability). SVD of the centered cloud."""
    pts = np.asarray(points, np.float64)
    centered = pts - pts.mean(axis=0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    n = vt[-1]
    return n / np.linalg.norm(n)


__all__ = [
    "have_native",
    "load",
    "library_path",
    "vertex_neighbours",
    "smooth_mesh",
    "load_stl",
    "voxelize_mesh",
    "fit_plane_normal",
]
