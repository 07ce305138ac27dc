"""Snapshot writers of the reference's auxiliary outputs (a jax-free copy
of lbm_tpu/io/snapshots.py's writers; given the same arrays the files are
byte for byte lbm_tpu's):
  - midplane map (bifurcation.cu write_once -> meas1.txt)
  - fluid-masked midplane (bifurcation.cu outtxt -> s1_out.txt)
  - boundary-cell velocity CSV (coronary.cu write_once -> vel.csv)
  - every live cell's velocity (bifurcation.cu write_vel -> scenario3a.txt)
and the measured-midplane ingest and comparison (read_midplane,
compare_midplane). u may be a NumPy array or a tensor (read to the host).
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.geometry.mask import CellType


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def write_midplane(path: str, u, axis: int = 2, components=(1, 0)) -> None:
    """uy then ux over the full (y, x) mid-plane, x fastest (the
    bifurcation meas1.txt layout)."""
    u = _host(u)
    nz = u.shape[1 + axis]
    plane = np.take(u, nz // 2, axis=1 + axis)  # (3, nx, ny)
    with open(path, "w") as fh:
        for comp in components:
            fh.write(" ".join(f"{v:g}" for v in plane[comp].T.ravel()) + " ")


def write_midplane_fluid(path: str, u, mask, axis: int = 2,
                         components=(1, 0)) -> None:
    """write_midplane with zeros at non-fluid cells (s1_out.txt)."""
    u = _host(u)
    mask = np.asarray(mask)
    nz = u.shape[1 + axis]
    plane = np.take(u, nz // 2, axis=1 + axis)
    fl = np.take(mask, nz // 2, axis=axis) == CellType.FLUID
    with open(path, "w") as fh:
        for comp in components:
            vals = np.where(fl, plane[comp], 0.0)
            fh.write(" ".join(f"{v:g}" for v in vals.T.ravel()) + " ")


def write_bc_csv(path: str, u, mask, labels=(2, 3, 5, 6, 7)) -> None:
    """x,y,z,ux,uy,uz rows for every boundary-labelled cell, z outer, y,
    x inner (vel.csv)."""
    u = _host(u)
    mask = np.asarray(mask)
    sel = np.isin(mask, np.asarray(labels))
    xs, ys, zs = np.nonzero(sel)
    order = np.lexsort((xs, ys, zs))
    with open(path, "w") as fh:
        for i in order:
            x, y, z = xs[i], ys[i], zs[i]
            fh.write(
                f"{x},{y},{z},{u[0,x,y,z]:f},{u[1,x,y,z]:f},{u[2,x,y,z]:f}\n"
            )


def write_live_velocities(path: str, u, mask) -> None:
    """All live-cell velocities, one z-slab per line, y outer and x
    fastest within it (the bifurcation write_vel / scenario3a.txt dump)."""
    u = _host(u)
    live = np.asarray(mask) != CellType.DEAD
    nz = u.shape[3]
    with open(path, "w") as fh:
        for z in range(nz):
            sel = live[:, :, z].T.ravel()  # y outer, x fastest
            comps = [u[c, :, :, z].T.ravel()[sel] for c in range(3)]
            row = np.stack(comps, axis=1).ravel()
            fh.write(" ".join(f"{v:g}" for v in row) + " \n")


def read_midplane(path: str, shape_xy, mask=None, axis: int = 2,
                  ncomp: int = 2):
    """A measured midplane profile in the meas1.txt layout (ncomp
    full-plane scans, x fastest within each y row) as (ncomp, nx, ny)
    float64 arrays: the reference's measured-data ingest (bifurcation.cu
    read_vel), which zeroes every non-fluid cell when a mask is given.
    Round-trips write_midplane_fluid."""
    nx, ny = shape_xy
    with open(path) as fh:
        vals = np.array(fh.read().split(), dtype=np.float64)
    if vals.size != ncomp * nx * ny:
        raise ValueError(
            f"{path}: expected {ncomp}x{nx}x{ny}={ncomp*nx*ny} values, "
            f"got {vals.size}"
        )
    planes = vals.reshape(ncomp, ny, nx).transpose(0, 2, 1)  # (c, x, y)
    if mask is not None:
        m = np.asarray(mask)
        fl = np.take(m, m.shape[axis] // 2, axis=axis) == CellType.FLUID
        planes = np.where(fl[None], planes, 0.0)
    return planes


def compare_midplane(measured, computed, fluid=None):
    """Error statistics between a measured midplane profile (read_midplane)
    and a computed one, over the `fluid` cells: dict(l2_rel, linf, rmse,
    corr, n): relative L2, max abs error, RMSE, Pearson correlation, cell
    count. Either may be a tensor."""
    a = np.asarray(_host(measured), np.float64)
    b = np.asarray(_host(computed), np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if fluid is not None:
        sel = np.broadcast_to(np.asarray(fluid, bool)[None], a.shape)
        a, b = a[sel], b[sel]
    else:
        a, b = a.ravel(), b.ravel()
    diff = a - b
    denom = float(np.linalg.norm(a))
    corr = 0.0
    if a.size > 1 and a.std() > 0 and b.std() > 0:
        corr = float(np.corrcoef(a, b)[0, 1])
    return {
        "l2_rel": float(np.linalg.norm(diff)) / (denom if denom else 1.0),
        "linf": float(np.abs(diff).max(initial=0.0)),
        "rmse": float(np.sqrt(np.mean(diff**2))) if diff.size else 0.0,
        "corr": corr,
        "n": int(a.size),
    }


__all__ = ["write_midplane", "write_midplane_fluid", "write_bc_csv",
           "write_live_velocities", "read_midplane", "compare_midplane"]
