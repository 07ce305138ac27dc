"""Poiseuille pipe flow (reference: Poiseulle_flow/Poiseulle.cu), as in
lbm_tpu/cases/poiseuille.py.

64^3 circular pipe along y, parabolic velocity inlet (y=1) and outlet
(y=NY-2) with extrapolated density, tau = 0.58. It exercises the NEE
branches the lid does not: a lateral u field and a second plane.
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.cases import register
from lbm_tpu_torch.core.units import UnitSystem
from lbm_tpu_torch.engine.spec import CaseSpec, PlaneBC
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.geometry.shapes import pipe_mask, pipe_parabola


@register("poiseuille")
def build(
    n: int = 64,
    tau: float = 0.58,
    u_max_phys: float = 0.15,
    CH: float = 0.0000655737,
    C_U: float = 1.5441,
    max_steps: int = 10000,
    time_save: int = 500,
    collision: str = "bgk",
    magic_lambda: float = 0.1875,
    mrt_rates=None,
    smagorinsky_cs=None,
    rheology=None,
    force=None,
    windkessel=None,
    windkessel_p0: float = 0.0,
) -> CaseSpec:
    """windkessel: optional (Rp, C, Rd) in lattice units — a pressure
    outlet coupled to an RCR model."""
    units = UnitSystem(CH=CH, C_U=C_U, C_rho=1060.0)
    u_max = u_max_phys / C_U
    mask = pipe_mask(n, n, n)
    parab = pipe_parabola(n, n, u_max)  # (nx, nz) lateral field
    u_field = np.zeros((3, n, n), np.float32)
    u_field[1] = parab
    inlet = PlaneBC(
        mask_value=int(CellType.INLET), axis=1, coord=1, normal=+1,
        rho_mode="extrapolate", u_mode="field", u_field=u_field,
    )
    if windkessel is not None:
        outlet = PlaneBC(
            mask_value=int(CellType.OUTLET), axis=1, coord=n - 2,
            normal=-1, rho_mode="fixed", rho_value=1.0,
            u_mode="extrapolate",
            windkessel=windkessel, windkessel_p0=windkessel_p0,
        )
    else:
        outlet = PlaneBC(
            mask_value=int(CellType.OUTLET), axis=1, coord=n - 2,
            normal=-1, rho_mode="extrapolate", u_mode="field",
            u_field=u_field,
        )
    u0 = np.zeros((3, n, n, n), np.float32)
    live = mask != CellType.DEAD
    # parabolic uy on rows y in {0, 1, NY-2, NY-1} for every live cell
    for y in (0, 1, n - 2, n - 1):
        u0[1, :, y, :] = np.where(live[:, y, :], parab, 0.0)
    return CaseSpec(
        name="poiseuille",
        shape=(n, n, n),
        tau=tau,
        units=units,
        mask=mask,
        boundaries=[inlet, outlet],
        u0=u0,
        max_steps=max_steps,
        time_save=time_save,
        tol=1e-6,
        stag_max=50,
        residual_flavor="velsum",
        vtk_crops=(2, 2, 2),
        collision=collision,
        magic_lambda=magic_lambda,
        mrt_rates=mrt_rates,
        smagorinsky_cs=smagorinsky_cs,
        rheology=rheology,
        force=force,
    )


def analytic_profile(n: int, u_max_phys: float = 0.15, C_U: float = 1.5441):
    """The exact steady solution on the pipe cross-section (lattice
    units)."""
    return pipe_parabola(n, n, u_max_phys / C_U)
