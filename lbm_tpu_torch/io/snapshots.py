"""Snapshot writers of the reference's auxiliary outputs (a jax-free copy
of lbm_tpu/io/snapshots.py's writers; given the same arrays the files are
byte for byte lbm_tpu's):
  - midplane map (bifurcation.cu write_once -> meas1.txt)
  - fluid-masked midplane (bifurcation.cu outtxt -> s1_out.txt)
  - boundary-cell velocity CSV (coronary.cu write_once -> vel.csv)
u may be a NumPy array or a tensor (read to the host).
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


__all__ = ["write_midplane", "write_midplane_fluid", "write_bc_csv"]
