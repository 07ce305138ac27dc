"""VTK STRUCTURED_POINTS writers compatible with the reference's output
(a jax-free copy of lbm_tpu/io/vtk.py without the wall-shear field).

Conventions: point order z outer, y middle, x inner; per-axis interior
crops; physical units (velocity * C_U, density * C_rho, pressure
rho * C_pre / 3); dead cells written as zeros.
"""

from __future__ import annotations

import os

import numpy as np

from lbm_tpu_torch.geometry.mask import CellType


def _crop(arr: np.ndarray, crops: tuple[int, int, int]) -> np.ndarray:
    cx, cy, cz = crops
    nx, ny, nz = arr.shape[-3:]
    return arr[..., cx : nx - cx, cy : ny - cy, cz : nz - cz]


def write_structured_points(
    path: str,
    fields: dict[str, np.ndarray],
    spacing: float,
    origin: tuple[float, float, float],
    crops: tuple[int, int, int] = (0, 0, 0),
    binary: bool = False,
    header: str = "lbm_tpu output",
) -> None:
    """fields: name -> array; (nx,ny,nz) scalars or (3,nx,ny,nz) vectors."""
    sample = next(iter(fields.values()))
    nx, ny, nz = _crop(sample, crops).shape[-3:]

    with open(path, "wb") as fh:
        def w(s: str):
            fh.write(s.encode())

        w("# vtk DataFile Version 2.0\n")
        w(f"<-- {header} -->\n")
        w("BINARY\n" if binary else "ASCII\n")
        w("DATASET STRUCTURED_POINTS\n")
        w(f"DIMENSIONS {nx} {ny} {nz}\n")
        w(f"SPACING {spacing:g} {spacing:g} {spacing:g}\n")
        w(f"ORIGIN {origin[0]:g} {origin[1]:g} {origin[2]:g}\n")
        w(f"POINT_DATA  {nx * ny * nz}\n")
        for name, arr in fields.items():
            arr = _crop(np.asarray(arr, np.float32), crops)
            if arr.ndim == 3:
                w(f"SCALARS {name} float\nLOOKUP_TABLE default\n")
                flat = arr.transpose(2, 1, 0).ravel()
            else:
                w(f"VECTORS {name} float\n")
                flat = arr.transpose(3, 2, 1, 0).reshape(-1)  # x fastest
            if binary:
                flat.astype(">f4").tofile(fh)
                w("\n")
            else:
                np.savetxt(fh, flat.reshape(1, -1), fmt="%g", newline=" ")
                w("\n")


def case_vtk(
    sim,
    out_dir: str,
    step: int,
    include_density: bool = False,
    binary: bool = False,
) -> str:
    """Write the per-save VTK snapshot of a Simulation, in physical units
    with dead cells zeroed."""
    spec = sim.spec
    units = spec.units
    rho, u = sim.macro()
    rho = rho.cpu().numpy()
    u = u.cpu().numpy()
    live = np.asarray(spec.mask) != CellType.DEAD
    u = np.where(live[None], u, 0.0) * units.C_U
    nx, ny, nz = spec.shape
    off = spec.vtk_origin_offset
    origin = (round(nx / 2 + off) * units.CH,
              round(ny / 2 + off) * units.CH, 0.0)
    fields: dict[str, np.ndarray] = {}
    if include_density:
        fields["DENSITY"] = np.where(live, rho, 0.0) * units.C_rho
        fields["PRESSURE"] = np.where(live, rho, 0.0) * units.C_pre / 3.0
    fields["VELOCITY"] = u
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{spec.name}_{step}.vtk")
    write_structured_points(
        path, fields, spacing=units.CH, origin=origin, crops=spec.vtk_crops,
        binary=binary,
    )
    return path


__all__ = ["write_structured_points", "case_vtk"]
