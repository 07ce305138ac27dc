"""The lid-driven cavity of the reference's Lid_driven_cavity/ldc.cu: an
n^3 box, its outer layer DEAD, the next WALL, fluid inside, and the lid,
an NEE velocity plane at y = n - 2 moving along +z at u_lid_phys / C_U,
rho extrapolated; u0 = u_max along z on the planes y = n - 1 and n - 2
(ldc.cu:522-532)."""

from __future__ import annotations

import numpy as np

from lbm_bench.reference.geometry import Geometry, Plane
from lbm_bench.reference.lattice import FLUID, INLET, WALL


def build(n: int = 64, tau: float = 0.55, u_lid_phys: float = 0.15,
          C_U: float = 2.4705) -> Geometry:
    u_max = u_lid_phys / C_U
    mask = np.zeros((n, n, n), np.int32)
    mask[1:-1, 1:-1, 1:-1] = WALL
    mask[2:-2, 2:-2, 2:-2] = FLUID
    mask[1:-1, n - 2, 1:-1] = INLET
    u0 = np.zeros((3, n, n, n), np.float32)
    u0[2, :, n - 1, :] = u_max
    u0[2, :, n - 2, :] = u_max
    lid = Plane(label=INLET, axis=1, coord=n - 2, normal=-1,
                rho="extrapolate", u="fixed", u_value=(0.0, 0.0, u_max))
    return Geometry(shape=(n, n, n), mask=mask, u0=u0, tau=float(tau),
                    planes=[lid], residual="velsum")
