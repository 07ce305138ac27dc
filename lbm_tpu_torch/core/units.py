"""Lattice <-> physical unit conversion.

The reference hard-codes per-case converter constants (ldc.cu:49-52):
CH (grid spacing, m), C_U (velocity scale, m/s), C_rho (density scale,
kg/m^3), with derived C_pre = C_rho * C_U^2 and C_T = CH / C_U
(documented in Lid_driven_cavity/README.md: C_T = 2.6543e-05 s).

Pressure output follows coronary.cu:983: p_phys = rho_lat * C_pre / 3.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    CH: float  # grid spacing [m]
    C_U: float  # velocity scale [m/s]
    C_rho: float = 1060.0  # density scale [kg/m^3] (blood in all cases)

    @property
    def C_pre(self) -> float:
        return self.C_rho * self.C_U * self.C_U

    @property
    def C_T(self) -> float:
        return self.CH / self.C_U

    def to_lattice_velocity(self, u_phys: float) -> float:
        return u_phys / self.C_U

    def to_physical_velocity(self, u_lat):
        return u_lat * self.C_U

    def to_physical_density(self, rho_lat):
        return rho_lat * self.C_rho

    def to_physical_pressure(self, rho_lat):
        return rho_lat * self.C_pre / 3.0

    def to_lattice_resistance(self, R_phys: float) -> float:
        """Hydraulic resistance [Pa·s/m^3] -> lattice (P_lat/Q_lat with
        Q_lat = volume flux in cells^3/step = Q_phys·C_T/CH^3 and
        P_lat = P_phys/C_pre — the windkessel parameter units."""
        return R_phys * self.CH * self.CH * self.C_U / self.C_pre

    def to_lattice_compliance(self, C_phys: float) -> float:
        """Vascular compliance [m^3/Pa] -> lattice (V_lat/P_lat =
        C_phys·C_pre/CH^3)."""
        return C_phys * self.C_pre / (self.CH ** 3)

    def to_lattice_diffusivity(self, D_phys: float) -> float:
        """Scalar diffusivity [m^2/s] -> lattice (same dimensions as
        viscosity: D_lat = D_phys·C_T/CH^2 = D_phys/(CH·C_U)) — the
        advection-diffusion transport parameter (engine/scalar.py)."""
        return D_phys / (self.CH * self.C_U)

    @staticmethod
    def from_viscosity(nu_phys: float, CH: float, tau: float,
                       C_rho: float = 1060.0) -> "UnitSystem":
        """Derive C_U from physical kinematic viscosity and tau.

        nu_lat = (tau - 0.5)/3, and nu_phys = nu_lat * CH * C_U, so
        C_U = nu_phys / (nu_lat * CH). This reproduces the reference's
        per-case constants (e.g. ldc: nu=2.7e-6 m^2/s, CH=6.55737e-5 m,
        tau=0.55 -> C_U ~= 2.4705, matching ldc.cu:49).
        """
        nu_lat = (tau - 0.5) / 3.0
        return UnitSystem(CH=CH, C_U=nu_phys / (nu_lat * CH), C_rho=C_rho)


__all__ = ["UnitSystem"]
