"""VTK STRUCTURED_POINTS writers compatible with the reference's output
(a jax-free copy of lbm_tpu/io/vtk.py).

Conventions: point order z outer, y middle, x inner; per-axis interior
crops; physical units (velocity * C_U, density * C_rho, pressure
rho * C_pre / 3); dead cells written as zeros. A field may be a NumPy
array or a torch tensor; each is cropped and put in point order as a
tensor on its own device (case_vtk's fields stay on the run's device),
and only the ordered float32 values cross to the host: at 512^3 the
host's strided transposes of ~5 box-sized arrays took ~30 s.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lbm_tpu_torch.geometry.mask import CellType


def _crop(arr, crops: tuple[int, int, int]):
    cx, cy, cz = crops
    nx, ny, nz = arr.shape[-3:]
    return arr[..., cx : nx - cx, cy : ny - cy, cz : nz - cz]


def _point_order(arr: torch.Tensor, crops) -> np.ndarray:
    """A (nx, ny, nz) scalar or (3, nx, ny, nz) vector field cropped, as a
    1-D float32 array in point order (z outer, x inner; a vector's three
    components innermost), ordered on the tensor's device."""
    arr = _crop(arr.float(), crops)
    order = (2, 1, 0) if arr.dim() == 3 else (3, 2, 1, 0)
    return arr.permute(order).contiguous().cpu().numpy().reshape(-1)


def write_structured_points(
    path: str,
    fields: dict,
    spacing: float,
    origin: tuple[float, float, float],
    crops: tuple[int, int, int] = (0, 0, 0),
    binary: bool = False,
    header: str = "lbm_tpu output",
) -> None:
    """fields: name -> array or tensor; (nx,ny,nz) scalars or
    (3,nx,ny,nz) vectors."""
    sample = next(iter(fields.values()))
    nx, ny, nz = tuple(_crop(sample, crops).shape[-3:])

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
            if not torch.is_tensor(arr):
                arr = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
            if arr.ndim == 3:
                w(f"SCALARS {name} float\nLOOKUP_TABLE default\n")
            else:
                w(f"VECTORS {name} float\n")
            flat = _point_order(arr, crops)
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
    include_wss: bool = False,
    extra_fields: dict | None = None,
) -> str:
    """Write the per-save VTK snapshot of a Simulation, in physical units
    with dead cells zeroed; include_wss adds the wall shear stress WSS in
    Pa (Simulation.wss), extra_fields more named fields as they are
    (TAWSS and OSI)."""
    spec = sim.spec
    units = spec.units
    rho, u = sim.macro()
    live = torch.from_numpy(np.asarray(spec.mask) != CellType.DEAD).to(
        u.device)
    nx, ny, nz = spec.shape
    off = spec.vtk_origin_offset
    origin = (round(nx / 2 + off) * units.CH,
              round(ny / 2 + off) * units.CH, 0.0)
    fields: dict = {}
    if include_density:
        rho = torch.where(live, rho, 0.0)
        fields["DENSITY"] = rho * units.C_rho
        fields["PRESSURE"] = rho * units.C_pre / 3.0
    del rho
    fields["VELOCITY"] = torch.where(live, u, 0.0) * units.C_U
    del u, live
    if include_wss:
        fields["WSS"] = sim.wss() * units.C_pre
    for name, arr in (extra_fields or {}).items():
        fields[name] = np.asarray(arr)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{spec.name}_{step}.vtk")
    write_structured_points(
        path, fields, spacing=units.CH, origin=origin, crops=spec.vtk_crops,
        binary=binary,
    )
    return path


__all__ = ["write_structured_points", "case_vtk"]
