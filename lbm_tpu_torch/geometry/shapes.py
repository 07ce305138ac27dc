"""Analytic geometry of the ported cases (the lid cavity and the circular
pipe of lbm_tpu/geometry/shapes.py), NumPy on the host."""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.geometry.mask import (
    CellType,
    end_plane_min_label,
    erode_label,
    ghost_dilate,
)


def cavity_mask(nx: int, ny: int, nz: int) -> np.ndarray:
    """Lid-driven cavity: outermost layer dead, next layer wall, moving lid
    (INLET, a velocity BC) on the plane y = ny-2, fluid inside."""
    geo = np.zeros((nx, ny, nz), dtype=np.int32)
    geo[1:-1, 1:-1, 1:-1] = CellType.WALL
    geo[2:-2, 2:-2, 2:-2] = CellType.FLUID
    geo[1:-1, ny - 2, 1:-1] = CellType.INLET
    return geo


def pipe_mask(nx: int, ny: int, nz: int) -> np.ndarray:
    """Circular pipe along y: a cylinder of radius (nx-1)/2 for y in
    1..ny-2, 3-pass erosion labeling over y in 2..ny-3, inlet 2 at y=1,
    outlet 3 at y=ny-2, ghost dilation from {wall, inlet, outlet}."""
    cx, cz = (nx - 1) / 2.0, (nz - 1) / 2.0
    radius = (nx - 1) / 2.0
    x = np.arange(nx, dtype=np.float32)[:, None]
    z = np.arange(nz, dtype=np.float32)[None, :]
    disc = (np.sqrt((x - cx) ** 2 + (z - cz) ** 2) <= radius).astype(np.int32)
    flag = np.zeros((nx, ny, nz), dtype=np.int32)
    flag[:, 1 : ny - 1, :] = disc[:, None, :]
    geo = erode_label(
        flag, passes=3,
        region=(slice(1, nx - 1), slice(2, ny - 2), slice(1, nz - 1)),
    )
    geo = end_plane_min_label(geo, flag, axis=1, coord=1, passes=1)
    geo = end_plane_min_label(geo, flag, axis=1, coord=ny - 2, passes=2)
    geo = ghost_dilate(
        geo, source_labels=(CellType.WALL, CellType.INLET, CellType.OUTLET)
    )
    return geo


def pipe_parabola(nx: int, nz: int, u_max: float) -> np.ndarray:
    """Parabolic inflow u(r) = u_max (1 - r^2/R^2) on the pipe
    cross-section, negative outside the radius. Shape (nx, nz)."""
    cx, cz = (nx - 1) / 2.0, (nz - 1) / 2.0
    radius = (nx - 1) / 2.0
    x = np.arange(nx, dtype=np.float32)[:, None]
    z = np.arange(nz, dtype=np.float32)[None, :]
    r2 = (x - cx) ** 2 + (z - cz) ** 2
    return (u_max * (1.0 - r2 / radius**2)).astype(np.float32)


__all__ = ["cavity_mask", "pipe_mask", "pipe_parabola"]
