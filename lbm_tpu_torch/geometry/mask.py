"""Cell labels and mask derivation (NumPy on the host; a jax-free copy of
the parts of lbm_tpu/geometry/mask.py the ported cases use).

The label scheme: not-used 0, wall 1, inlet 2, outlet 3, fluid 4,
ghost -1, moving wall -2; extra outlet labels (5, 6, 7, ...) are allowed.
Labels are negative as well as positive, so a mask on the device is
int8, never uint8.
"""

from __future__ import annotations

import enum

import numpy as np

from lbm_tpu_torch.core.lattice import D3Q19


class CellType(enum.IntEnum):
    GHOST = -1
    DEAD = 0
    WALL = 1
    INLET = 2
    OUTLET = 3
    FLUID = 4
    MOVING = -2


def _min6(flag: np.ndarray) -> np.ndarray:
    """Min over the 6 face neighbors, valid on the interior (1..N-2)."""
    m = np.minimum(flag[2:, 1:-1, 1:-1], flag[:-2, 1:-1, 1:-1])
    m = np.minimum(m, np.minimum(flag[1:-1, 2:, 1:-1], flag[1:-1, :-2, 1:-1]))
    m = np.minimum(m, np.minimum(flag[1:-1, 1:-1, 2:], flag[1:-1, 1:-1, :-2]))
    return m


def erode_label(
    flag: np.ndarray,
    geo: np.ndarray | None = None,
    passes: int = 3,
    region: tuple[slice, slice, slice] | None = None,
) -> np.ndarray:
    """Bulk erosion labeling: geo[cell] += passes * min(6-neighbors of flag)
    over `region` (default the full interior 1..N-2). Interior cells become
    1 + passes = 4 (fluid); surface cells stay 1 (wall)."""
    flag = np.asarray(flag)
    geo = flag.astype(np.int32).copy() if geo is None else geo
    nx, ny, nz = flag.shape
    if region is None:
        region = (slice(1, nx - 1), slice(1, ny - 1), slice(1, nz - 1))
    m6 = _min6(flag.astype(np.int32))  # indexed from (1,1,1)
    sx, sy, sz = region
    sub = (
        slice(sx.start - 1, sx.stop - 1),
        slice(sy.start - 1, sy.stop - 1),
        slice(sz.start - 1, sz.stop - 1),
    )
    geo[sx, sy, sz] += passes * m6[sub]
    return geo


def end_plane_min_label(
    geo: np.ndarray,
    flag: np.ndarray,
    axis: int,
    coord: int,
    passes: int,
    window: tuple[slice, slice] | None = None,
) -> np.ndarray:
    """End-plane relabel: geo[plane cell] += passes * min(4 in-plane
    neighbors of flag) (passes=1 -> inlet 2, passes=2 -> outlet 3)."""
    lat_axes = [a for a in range(3) if a != axis]
    flag = np.asarray(flag).astype(np.int32)
    plane_flag = np.take(flag, coord, axis=axis)  # (A, B) lateral
    a_n, b_n = plane_flag.shape
    if window is None:
        window = (slice(1, a_n - 1), slice(1, b_n - 1))
    wa, wb = window
    m = np.minimum(plane_flag[wa.start + 1 : wa.stop + 1, wb],
                   plane_flag[wa.start - 1 : wa.stop - 1, wb])
    m = np.minimum(m, plane_flag[wa, wb.start + 1 : wb.stop + 1])
    m = np.minimum(m, plane_flag[wa, wb.start - 1 : wb.stop - 1])
    idx: list = [slice(None)] * 3
    idx[axis] = coord
    idx[lat_axes[0]] = wa
    idx[lat_axes[1]] = wb
    geo[tuple(idx)] += passes * m
    return geo


def ghost_dilate(geo: np.ndarray, source_labels=(CellType.WALL,)) -> np.ndarray:
    """Mark any 18-neighbor of a source-labeled interior cell that is DEAD
    as GHOST (-1). Only sources in the interior box 1..N-2 emit."""
    src = np.isin(geo, np.asarray(source_labels, dtype=geo.dtype))
    interior = np.zeros_like(src)
    interior[1:-1, 1:-1, 1:-1] = src[1:-1, 1:-1, 1:-1]
    marked = np.zeros_like(src)
    for i in range(1, D3Q19.Q):
        ex, ey, ez = D3Q19.E[i]
        marked |= np.roll(interior, shift=(ex, ey, ez), axis=(0, 1, 2))
    geo = geo.copy()
    geo[(geo == CellType.DEAD) & marked] = CellType.GHOST
    return geo


__all__ = ["CellType", "erode_label", "end_plane_min_label", "ghost_dilate"]
