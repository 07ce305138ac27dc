"""Lid-driven cavity (reference: Lid_driven_cavity/ldc.cu), as in
lbm_tpu/cases/lid_driven_cavity.py.

64^3 cavity, moving lid at y = NY-2 with physical speed 0.15 m/s along
+z, tau = 0.55, blood-like units. Steady run, per-step |u|-sum residual,
stop after 50 consecutive sub-1e-6 residuals.
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.cases import register
from lbm_tpu_torch.core.units import UnitSystem
from lbm_tpu_torch.engine.spec import CaseSpec, PlaneBC
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.geometry.shapes import cavity_mask


@register("lid_driven_cavity")
def build(
    n: int = 64,
    tau: float = 0.55,
    u_lid_phys: float = 0.15,
    CH: float = 0.0000655737,
    C_U: float = 2.4705,
    max_steps: int = 10000,
    time_save: int = 500,
    collision: str = "bgk",
    magic_lambda: float = 0.1875,
    mrt_rates=None,
    smagorinsky_cs=None,
    rheology=None,
    force=None,
    lid: str = "nee",
) -> CaseSpec:
    """lid='nee' is the reference's NEE velocity plane; lid='bounceback'
    labels the lid MOVING: half-way bounce-back plus the Ladd momentum
    term of CaseSpec.wall_velocity."""
    if lid not in ("nee", "bounceback"):
        raise ValueError(f"lid must be 'nee' or 'bounceback': {lid!r}")
    units = UnitSystem(CH=CH, C_U=C_U, C_rho=1060.0)
    u_max = u_lid_phys / C_U
    mask = cavity_mask(n, n, n)
    wall_velocity = None
    if lid == "nee":
        # inward normal -y, rho extrapolated, u = (0, 0, u_max)
        boundaries = [PlaneBC(
            mask_value=int(CellType.INLET),
            axis=1,
            coord=n - 2,
            normal=-1,
            rho_mode="extrapolate",
            u_mode="fixed",
            u_value=(0.0, 0.0, u_max),
        )]
    else:
        mask = np.where(mask == int(CellType.INLET),
                        np.int32(int(CellType.MOVING)), mask)
        boundaries = []
        wall_velocity = (0.0, 0.0, u_max)
    u0 = np.zeros((3, n, n, n), np.float32)
    # uz = u_max on the full y = NY-1 and y = NY-2 planes (ldc.cu:522-532)
    u0[2, :, n - 1, :] = u_max
    u0[2, :, n - 2, :] = u_max
    return CaseSpec(
        name="lid_driven_cavity",
        shape=(n, n, n),
        tau=tau,
        units=units,
        mask=mask,
        boundaries=boundaries,
        u0=u0,
        max_steps=max_steps,
        time_save=time_save,
        tol=1e-6,
        stag_max=50,
        residual_flavor="velsum",
        vtk_crops=(2, 2, 2),
        vtk_origin_offset=-1,  # ldc.cu:594 writes round(NX/2-1)*CH
        collision=collision,
        magic_lambda=magic_lambda,
        mrt_rates=mrt_rates,
        smagorinsky_cs=smagorinsky_cs,
        rheology=rheology,
        force=force,
        wall_velocity=wall_velocity,
    )
