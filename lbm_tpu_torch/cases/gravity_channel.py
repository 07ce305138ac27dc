"""Gravity-driven square duct, as in lbm_tpu/cases/gravity_channel.py.

A straight square duct along z (walls on the four x/y sides, z fully
periodic) driven by a constant body force along z through Guo's scheme
(CaseSpec.force); no boundary planes. The steady state is the
rectangular-duct Poiseuille profile.
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.cases import register
from lbm_tpu_torch.core.units import UnitSystem
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.geometry.mask import CellType


@register("gravity_channel")
def build(
    n: int = 32,
    nz: int = 32,
    tau: float = 0.6,
    fz: float = 1e-5,
    collision: str = "bgk",
    magic_lambda: float = 0.1875,
    mrt_rates=None,
    smagorinsky_cs=None,
    rheology=None,
    CH: float = 0.0000655737,
    C_U: float = 2.4705,
    max_steps: int = 20000,
    time_save: int = 500,
) -> CaseSpec:
    units = UnitSystem(CH=CH, C_U=C_U, C_rho=1060.0)
    mask = np.zeros((n, n, nz), np.int32)
    mask[1:-1, 1:-1, :] = CellType.WALL
    mask[2:-2, 2:-2, :] = CellType.FLUID
    return CaseSpec(
        name="gravity_channel",
        shape=(n, n, nz),
        tau=tau,
        units=units,
        mask=mask,
        boundaries=[],
        force=(0.0, 0.0, fz),
        collision=collision,
        magic_lambda=magic_lambda,
        mrt_rates=mrt_rates,
        smagorinsky_cs=smagorinsky_cs,
        rheology=rheology,
        max_steps=max_steps,
        time_save=time_save,
        tol=1e-6,
        stag_max=50,
        residual_flavor="velsum",
        vtk_crops=(2, 2, 0),
    )
