"""geo_preprocess: STL surface -> labeled Cartesian lattice (a jax-free
copy of lbm_tpu/geometry/preprocess.py).

The reference describes a MATLAB `geo_preprocess` that voxelizes a
reconstructed surface into the 6-valued mask but does not ship it; the
shipped bifurcation geo.txt is its binary-occupancy output. This module
does it natively: STL -> (optional smoothing) -> parity voxelization ->
binary occupancy and/or fully labeled mask, plus geo.txt export. Host
code (NumPy and the native library of geometry/native.py).

CLI:  python -m lbm_tpu_torch.geometry.preprocess vessel.stl geo.txt \
          --shape 64 83 32 --inlet-axis 1 --inlet-coord 1 \
          --outlet-coord 81 [--smooth 10 --smooth-mode curvature]
"""

from __future__ import annotations

import argparse

import numpy as np

from lbm_tpu_torch.geometry.io import save_geo
from lbm_tpu_torch.geometry.mask import (
    CellType,
    end_plane_min_label,
    erode_label,
    ghost_dilate,
)
from lbm_tpu_torch.geometry.native import load_stl, smooth_mesh, voxelize_mesh


def stl_to_occupancy(
    stl_path: str,
    shape: tuple[int, int, int],
    smooth_iters: int = 0,
    smooth_mode: str = "curvature",
    margin: int = 2,
    spacing: float | None = None,
) -> np.ndarray:
    """spacing: cell size in the STL's own units — give the case's CH
    to register the voxelization on the solver grid (the mesh is then
    CENTERED in the box, which is how the shipped bifurcation geo.txt
    sits: bif.stl at spacing=CH*1e3 reproduces its occupied bbox
    exactly, x 2-62 / z 2-29 / y touching the 1 and ny-2 label planes).
    Default (None): isotropic fit with `margin` empty cells per side."""
    tris = load_stl(stl_path)
    if smooth_iters:
        verts, inv = np.unique(
            tris.reshape(-1, 3), axis=0, return_inverse=True
        )
        faces = inv.reshape(-1, 3).astype(np.int64)
        verts = smooth_mesh(verts, faces, iterations=smooth_iters,
                            mode=smooth_mode)
        tris = verts[faces]
    flag = voxelize_mesh(tris, shape, margin=margin, spacing=spacing)
    # Boundary ring must be empty for the labeling passes.
    flag[0], flag[-1] = 0, 0
    flag[:, 0], flag[:, -1] = 0, 0
    flag[:, :, 0], flag[:, :, -1] = 0, 0
    return flag


def extrude_open_ends(flag: np.ndarray, axis: int = 1,
                      full_frac: float = 0.9) -> np.ndarray:
    """Extend a vessel's OPEN end cross-sections along `axis` out to the
    box's penultimate planes.

    A surface STL of an open tube ends mid-box, so the voxelized tip
    planes carry partial cross-sections (bif.stl: 208 cells at y=1 vs
    413 at y=2) while the solver grid expects full openings at its
    label planes — the shipped bifurcation geo.txt carries full
    cross-sections all the way out (y=0: 401 cells). The first plane
    from each end whose count reaches `full_frac` of its inward
    neighbor is copied outward (outermost plane stays empty for the
    labeling passes)."""
    f = flag.copy()
    n = f.shape[axis]

    def plane(i):
        return np.take(f, i, axis=axis)

    def put(i, val):
        sl = [slice(None)] * 3
        sl[axis] = i
        f[tuple(sl)] = val

    counts = f.sum(axis=tuple(a for a in range(3) if a != axis))
    occ = np.nonzero(counts)[0]
    if occ.size == 0:
        return f
    lo = next(y for y in range(int(occ[0]), n - 1)
              if counts[y] >= full_frac * max(counts[y + 1], 1))
    hi = next(y for y in range(int(occ[-1]), 0, -1)
              if counts[y] >= full_frac * max(counts[y - 1], 1))
    for y in range(1, lo):
        put(y, plane(lo))
    for y in range(hi + 1, n - 1):
        put(y, plane(hi))
    return f


def label_occupancy(
    flag: np.ndarray,
    inlet_axis: int = 1,
    inlet_coord: int | None = None,
    outlet_coord: int | None = None,
) -> np.ndarray:
    """Occupancy -> 6-valued mask via the Poiseuille-style labeling
    (3-pass erosion -> fluid 4, in-plane min passes -> inlet 2/outlet 3,
    ghost dilation). Inlet/outlet planes default to the vessel's first
    and last occupied planes along `inlet_axis`."""
    other = tuple(a for a in range(3) if a != inlet_axis)
    occupied = np.nonzero(flag.sum(axis=other))[0]
    if occupied.size == 0:
        raise ValueError("empty occupancy grid")
    if inlet_coord is None:
        inlet_coord = int(occupied[0])
    if outlet_coord is None:
        outlet_coord = int(occupied[-1])
    # Cap the openings so the end planes erode like walls.
    capped = flag.copy()
    sl = [slice(None)] * 3
    sl[inlet_axis] = slice(0, inlet_coord)
    capped[tuple(sl)] = 0
    sl[inlet_axis] = slice(outlet_coord + 1, None)
    capped[tuple(sl)] = 0
    geo = erode_label(capped, passes=3)
    geo = end_plane_min_label(geo, capped, axis=inlet_axis,
                              coord=inlet_coord, passes=1)
    geo = end_plane_min_label(geo, capped, axis=inlet_axis,
                              coord=outlet_coord, passes=2)
    return ghost_dilate(geo, source_labels=(CellType.WALL,))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="geo_preprocess")
    ap.add_argument("stl")
    ap.add_argument("out")
    ap.add_argument("--shape", type=int, nargs=3, required=True)
    ap.add_argument("--smooth", type=int, default=0)
    ap.add_argument("--smooth-mode", default="curvature",
                    choices=["curvature", "inversedistance"])
    ap.add_argument("--binary", action="store_true",
                    help="write binary occupancy (the shipped geo.txt "
                         "format) instead of the labeled mask")
    ap.add_argument("--inlet-axis", type=int, default=1)
    ap.add_argument("--inlet-coord", type=int, default=None,
                    help="default: first occupied plane along the axis")
    ap.add_argument("--outlet-coord", type=int, default=None,
                    help="default: last occupied plane along the axis")
    ap.add_argument("--order", default="xyz", choices=["xyz", "yxz"])
    args = ap.parse_args(argv)

    flag = stl_to_occupancy(
        args.stl, tuple(args.shape), args.smooth, args.smooth_mode
    )
    if args.binary:
        save_geo(args.out, flag, order=args.order)
    else:
        geo = label_occupancy(
            flag, args.inlet_axis, args.inlet_coord, args.outlet_coord
        )
        save_geo(args.out, geo, order=args.order)
    print(f"wrote {args.out}: occupancy {flag.mean():.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
