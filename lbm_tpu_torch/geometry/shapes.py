"""Analytic geometry of the ported cases (the lid cavity, the circular
pipe and the quarter-torus curved vessel of lbm_tpu/geometry/shapes.py),
NumPy on the host."""

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


def curved_pipe_mask(
    nx: int, ny: int, nz: int, bend_radius: float, pipe_radius: float
) -> np.ndarray:
    """Quarter-torus curved vessel in the x-y plane: inlet plane y=1,
    outlet plane x=nx-2. The centerline is a circle of radius
    `bend_radius` around (cx0, cy0), so the tube enters along y at y=1
    and leaves along x at x=nx-2, with straight legs to both planes.
    Labels come from the pipe's erosion pipeline."""
    zc = (nz - 1) / 2.0
    cx0 = 1.0 + pipe_radius + bend_radius
    cy0 = 1.0 + pipe_radius + bend_radius  # symmetric quarter bend
    xs = np.arange(nx, dtype=np.float32)[:, None, None]
    ys = np.arange(ny, dtype=np.float32)[None, :, None]
    zs = np.arange(nz, dtype=np.float32)[None, None, :]
    rxy = np.sqrt((xs - cx0) ** 2 + (ys - cy0) ** 2)
    dist = np.sqrt((rxy - bend_radius) ** 2 + (zs - zc) ** 2)
    inside = dist <= pipe_radius
    quarter = (xs <= cx0) & (ys <= cy0)
    leg_in = (np.abs(xs - (cx0 - bend_radius)) <= pipe_radius) & (ys <= cy0)
    leg_in = leg_in & (np.sqrt((xs - (cx0 - bend_radius)) ** 2
                               + (zs - zc) ** 2) <= pipe_radius)
    leg_out = (np.abs(ys - (cy0 - bend_radius)) <= pipe_radius) & (xs >= cx0)
    leg_out = leg_out & (np.sqrt((ys - (cy0 - bend_radius)) ** 2
                                 + (zs - zc) ** 2) <= pipe_radius)
    flag = ((inside & quarter) | leg_in | leg_out).astype(np.int32)
    flag[:, 0, :] = 0
    flag[:, :, 0] = flag[:, :, -1] = 0
    flag[0, :, :] = 0
    # cap the open ends one layer inside the domain
    flag[:, ny - 1 :, :] = 0
    flag[nx - 1 :, :, :] = 0
    geo = erode_label(flag, passes=3)
    geo = end_plane_min_label(geo, flag, axis=1, coord=1, passes=1)
    geo = end_plane_min_label(geo, flag, axis=0, coord=nx - 2, passes=2)
    return ghost_dilate(geo, source_labels=(CellType.WALL,))


__all__ = ["cavity_mask", "pipe_mask", "pipe_parabola", "curved_pipe_mask"]
