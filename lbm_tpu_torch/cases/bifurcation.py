"""Carotid bifurcation (reference: bifurcation/bifurcation.cu), as in
lbm_tpu/cases/bifurcation.py.

64 x 83 x 32 vessel from geo.txt; measured velocity inlet at y=1 from
bc.txt, pressure outlet (rho* = 1, u* extrapolated) at y=NY-2; tau = 0.55
(kernel-local, bifurcation.cu:434,643); fixed 4400 steps, windowed u^2
residual (bifurcation.cu:19,1158-1175).

Data quirk: the shipped bc.txt holds the measured inlet profile in its
SECOND slab, whose nonzero footprint matches the y=1 inlet opening
cell-for-cell, while read_vel
(bifurcation.cu:294-326) reads slab 0 (all zeros) as the inlet — so the
reference as literally shipped runs with zero inflow. By default this
case uses the intended slab (`inlet_slab=1`); pass `strict_reference=True`
to reproduce the literal zero-inflow behavior.
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.cases import register
from lbm_tpu_torch.core.units import UnitSystem
from lbm_tpu_torch.engine.spec import CaseSpec, PlaneBC
from lbm_tpu_torch.geometry.io import load_bc, load_geo
from lbm_tpu_torch.geometry.mask import (
    CellType,
    end_plane_copy_label,
    erode_label,
    ghost_dilate,
)

SHAPE = (64, 83, 32)


def build_labels(flag: np.ndarray) -> np.ndarray:
    """bifurcation.cu:36-239 label derivation (vectorized)."""
    nx, ny, nz = flag.shape
    geo = flag.astype(np.int32).copy()
    geo[1 : nx - 1, 0, 1 : nz - 1] = 0
    geo[1 : nx - 1, ny - 1, 1 : nz - 1] = 0
    geo = erode_label(
        flag, geo=geo, passes=3,
        region=(slice(1, nx - 1), slice(2, ny - 2), slice(1, nz - 1)),
    )
    geo = end_plane_copy_label(geo, axis=1, coord=1, ref_coord=2, target=2)
    geo = end_plane_copy_label(
        geo, axis=1, coord=ny - 2, ref_coord=ny - 3, target=3
    )
    return ghost_dilate(geo, source_labels=(CellType.WALL,))


@register("bifurcation")
def build(
    geo_path: str = "/root/reference/bifurcation/geo.txt",
    bc_path: str = "/root/reference/bifurcation/bc.txt",
    tau: float = 0.55,
    strict_reference: bool = False,
    max_steps: int = 4400,
    time_save: int = 4400,
    collision: str = "bgk",
    magic_lambda: float = 0.1875,
    mrt_rates=None,
    smagorinsky_cs=None,
    rheology=None,
    force=None,
) -> CaseSpec:
    nx, ny, nz = SHAPE
    units = UnitSystem(CH=0.000248925, C_U=0.24159041, C_rho=998.2)
    flag = load_geo(geo_path, SHAPE, order="xyz")
    mask = build_labels(flag)
    slabs = load_bc(bc_path, nx, nz)
    inlet_slab = 0 if strict_reference else 1
    inlet_map = np.where(
        mask[:, 1, :] == CellType.INLET, slabs[inlet_slab], 0.0
    ).astype(np.float32)
    outlet_map = np.where(
        mask[:, ny - 2, :] == CellType.OUTLET, slabs[1], 0.0
    ).astype(np.float32)

    u_field = np.zeros((3, nx, nz), np.float32)
    u_field[1] = inlet_map
    inlet = PlaneBC(
        mask_value=int(CellType.INLET), axis=1, coord=1, normal=+1,
        rho_mode="extrapolate", u_mode="field", u_field=u_field,
    )
    # Pressure outlet: rho* = 1 prescribed, u* = u_F extrapolated
    # (bifurcation.cu:877-948, note the 1.f/18.0f equilibrium).
    outlet = PlaneBC(
        mask_value=int(CellType.OUTLET), axis=1, coord=ny - 2, normal=-1,
        rho_mode="fixed", rho_value=1.0, u_mode="extrapolate",
    )
    u0 = np.zeros((3,) + SHAPE, np.float32)
    live = mask != CellType.DEAD
    u0[1, :, 1, :] = np.where(live[:, 1, :], inlet_map, 0.0)
    u0[1, :, ny - 2, :] = np.where(live[:, ny - 2, :], outlet_map, 0.0)
    return CaseSpec(
        collision=collision,
        magic_lambda=magic_lambda,
        mrt_rates=mrt_rates,
        smagorinsky_cs=smagorinsky_cs,
        rheology=rheology,
        force=force,
        name="bifurcation",
        shape=SHAPE,
        tau=tau,
        units=units,
        mask=mask,
        boundaries=[inlet, outlet],
        u0=u0,
        max_steps=max_steps,
        time_save=time_save,
        tol=1e-6,
        stag_max=10**9,  # fixed-step run (bifurcation.cu:1246)
        residual_flavor="usq",
        vtk_crops=(1, 2, 1),
    )
