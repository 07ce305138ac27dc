"""Curved vessel with a pulsatile inlet, as in lbm_tpu/cases/curved_vessel.py.

A quarter-bend torus vessel (geometry/shapes.curved_pipe_mask), a
time-periodic parabolic velocity inlet at y=1 driven by a carotid-like
waveform sampled into a per-phase series (PlaneBC u_mode='series'), and
a pressure outlet at x=nx-2.
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.cases import register
from lbm_tpu_torch.core.units import UnitSystem
from lbm_tpu_torch.engine.spec import CaseSpec, PlaneBC
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.geometry.shapes import curved_pipe_mask


def pulse_waveform(nphase: int, base: float = 0.6, amp: float = 0.4):
    """A smooth systole/diastole-like periodic waveform in [base-amp/2, 1]."""
    t = np.linspace(0.0, 2 * np.pi, nphase, endpoint=False)
    w = base + amp * (np.sin(t) + 0.35 * np.sin(2 * t + 0.8))
    return np.clip(w, 0.05, None).astype(np.float32)


@register("curved_vessel")
def build(
    n: int = 64,
    tau: float = 0.55,
    u_max_phys: float = 0.15,
    CH: float = 0.0000655737,
    C_U: float = 2.4705,
    nphase: int = 40,
    period_steps: int = 2000,
    max_steps: int = 20000,
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
    """windkessel: optional (Rp, C, Rd) in lattice units on the pressure
    outlet."""
    units = UnitSystem(CH=CH, C_U=C_U, C_rho=1060.0)
    u_max = u_max_phys / C_U
    pipe_radius = n / 5.0
    bend_radius = n / 2.5
    mask = curved_pipe_mask(n, n, n, bend_radius, pipe_radius)

    # inlet: parabolic profile over the tube mouth at y=1, modulated by
    # the pulse waveform -> a (T, 3, nx, nz) series
    inlet_open = mask[:, 1, :] == CellType.INLET
    cx0 = 1.0 + pipe_radius + bend_radius
    zc = (n - 1) / 2.0
    x = np.arange(n, dtype=np.float32)[:, None]
    z = np.arange(n, dtype=np.float32)[None, :]
    r2 = (x - (cx0 - bend_radius)) ** 2 + (z - zc) ** 2
    parab = np.where(inlet_open, u_max * (1.0 - r2 / pipe_radius**2), 0.0)
    parab = np.clip(parab, 0.0, None).astype(np.float32)
    wave = pulse_waveform(nphase)
    series = np.zeros((nphase, 3, n, n), np.float32)
    series[:, 1] = wave[:, None, None] * parab[None]

    inlet = PlaneBC(
        mask_value=int(CellType.INLET), axis=1, coord=1, normal=+1,
        rho_mode="extrapolate", u_mode="series", u_series=series,
        u_series_stride=max(1, period_steps // nphase),
    )
    outlet = PlaneBC(
        mask_value=int(CellType.OUTLET), axis=0, coord=n - 2, normal=-1,
        rho_mode="fixed", rho_value=1.0, u_mode="extrapolate",
        windkessel=windkessel, windkessel_p0=windkessel_p0,
    )
    u0 = np.zeros((3, n, n, n), np.float32)
    live = mask != CellType.DEAD
    u0[1, :, 1, :] = np.where(live[:, 1, :], series[0, 1], 0.0)
    return CaseSpec(
        collision=collision,
        magic_lambda=magic_lambda,
        mrt_rates=mrt_rates,
        smagorinsky_cs=smagorinsky_cs,
        rheology=rheology,
        force=force,
        name="curved_vessel",
        shape=(n, n, n),
        tau=tau,
        units=units,
        mask=mask,
        boundaries=[inlet, outlet],
        u0=u0,
        max_steps=max_steps,
        time_save=time_save,
        tol=1e-6,
        stag_max=10**9,  # unsteady: fixed-length run
        residual_flavor="usq",
        vtk_crops=(1, 2, 1),
    )
