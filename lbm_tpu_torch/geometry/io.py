"""Loaders/savers for the reference's geometry and BC file formats (a
jax-free copy of lbm_tpu/geometry/io.py).

geo.txt: whitespace-separated integers in one of two orderings:
  - 'xyz' (x fastest, then y, then z), as bifurcation.cu writes it;
  - 'yxz' (y fastest, then x, then z), as coronary.cu reads it.
bc.txt: consecutive (nz, nx) slabs of floats (x fastest, then z); the
reference reads slab 0 as the inlet (y=1) map and slab 1 as the outlet
(y=ny-2) map.
"""

from __future__ import annotations

import numpy as np


def load_geo(path: str, shape: tuple[int, int, int],
             order: str = "xyz") -> np.ndarray:
    """Load a binary occupancy grid into an (nx, ny, nz) int32 array."""
    nx, ny, nz = shape
    vals = np.fromfile(path, dtype=np.int64, sep=" ").astype(np.int32)
    if vals.size != nx * ny * nz:
        raise ValueError(
            f"geo file {path} has {vals.size} entries, expected {nx*ny*nz}")
    if order == "xyz":  # z outer, y, x fastest
        return vals.reshape(nz, ny, nx).transpose(2, 1, 0).copy()
    if order == "yxz":  # z outer, x, y fastest
        return vals.reshape(nz, nx, ny).transpose(1, 2, 0).copy()
    raise ValueError(f"unknown geo order {order!r}")


def save_geo(path: str, flag: np.ndarray, order: str = "xyz") -> None:
    if order == "xyz":
        flat = flag.transpose(2, 1, 0).ravel()
    elif order == "yxz":
        flat = flag.transpose(2, 0, 1).ravel()
    else:
        raise ValueError(f"unknown geo order {order!r}")
    # chunked writes: one join of a coronary-sized grid (31.5M ints) would
    # build a ~100 MB string
    with open(path, "w") as fh:
        chunk = 1 << 20
        for i in range(0, flat.size, chunk):
            part = flat[i : i + chunk]
            fh.write(" ".join(map(str, part.tolist())))
            fh.write(" " if i + chunk < flat.size else "")


def load_bc(path: str, nx: int, nz: int) -> list[np.ndarray]:
    """The lattice-velocity map slabs of a bc.txt, each (nx, nz) f32."""
    vals = np.fromfile(path, dtype=np.float64, sep=" ").astype(np.float32)
    if vals.size % (nx * nz) != 0 or vals.size == 0:
        raise ValueError(
            f"bc file {path} has {vals.size} entries, not a multiple of "
            f"{nx*nz}")
    nslabs = vals.size // (nx * nz)
    return [
        vals[s * nx * nz : (s + 1) * nx * nz].reshape(nz, nx).T.copy()
        for s in range(nslabs)
    ]


__all__ = ["load_geo", "save_geo", "load_bc"]
