"""Canonical natural-convection cases for the Boussinesq thermal route
(engine/thermal.BuoyantTransport): a jax-free copy of
lbm_tpu/cases/thermal.py. Buoyancy-driven convection is the standard
second LBM application.

These functions are NOT in the CLI case registry: what runs them is
BuoyantTransport, not Simulation (the flow alone is force-free rest —
nothing happens without the coupled temperature). Each returns
(CaseSpec, thermal_kwargs, info): pass the kwargs straight to
BuoyantTransport(spec, **thermal_kwargs); info carries the derived
dimensionless bookkeeping (H, nu, kappa, Ra, Pr) the tests assert on.

Nondimensionalization (H = wall-to-wall distance — walls sit half-way
between the wall-cell and fluid-cell layers, so H = n_interior):

    nu = (tau - 1/2)/3,  kappa = nu/Pr,  tau_g = 1/2 + 4 kappa,
    |buoyancy| = Ra * nu * kappa / (dT * H^3)
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.core.units import UnitSystem
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.geometry.mask import CellType

_UNITS = UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0)


def _derive(tau: float, pr: float, ra: float, dT: float, H: int):
    nu = (tau - 0.5) / 3.0
    kappa = nu / pr
    tau_g = 0.5 + 4.0 * kappa
    b = ra * nu * kappa / (dT * float(H) ** 3)
    info = dict(H=H, nu=nu, kappa=kappa, tau_g=tau_g, Ra=ra, Pr=pr,
                dT=dT, b=b)
    return tau_g, b, info


def rayleigh_benard(nx: int = 32, ny: int = 1, nz: int = 18,
                    ra: float = 2500.0, pr: float = 1.0,
                    tau: float = 0.8, dT: float = 1.0,
                    perturb: float = 1e-3):
    """Rayleigh-Benard slab: isothermal rigid walls below (hot, +dT/2)
    and above (cold, -dT/2), periodic x/y, gravity along -z. The linear
    conduction profile is seeded with a single-wavelength thermal
    perturbation; kinetic energy decays for Ra below the rigid-rigid
    critical value 1708 and grows above it (the onset anchor,
    tests/test_thermal.py). Default nx = 2 H, close to the critical
    wavelength 2.016 H, so the seeded mode is the most unstable one."""
    H = nz - 2
    tau_g, b, info = _derive(tau, pr, ra, dT, H)
    mask = np.full((nx, ny, nz), int(CellType.FLUID), np.int32)
    mask[:, :, 0] = int(CellType.WALL)
    mask[:, :, -1] = int(CellType.WALL)
    wall_c = np.full((nx, ny, nz), np.nan, np.float32)
    wall_c[:, :, 0] = +0.5 * dT
    wall_c[:, :, -1] = -0.5 * dT
    # conduction profile at cell centers (walls half-way: z = 1/2 and
    # nz - 3/2), + the seeded mode, zero at both walls
    z = np.arange(nz, dtype=np.float64)
    lin = 0.5 * dT - dT * (z - 0.5) / H
    zi = np.clip((z - 0.5) / H, 0.0, 1.0)
    x = np.arange(nx, dtype=np.float64)
    mode = (np.sin(2.0 * np.pi * x / nx)[:, None, None]
            * np.sin(np.pi * zi)[None, None, :])
    c0 = (lin[None, None, :] + perturb * dT * mode).astype(np.float32)
    c0 = np.broadcast_to(c0, (nx, ny, nz)).copy()
    spec = CaseSpec(name="rayleigh_benard", shape=(nx, ny, nz),
                    tau=tau, units=_UNITS, mask=mask, boundaries=[])
    kwargs = dict(tau_g=tau_g, buoyancy=(0.0, 0.0, b), c_ref=0.0,
                  wall_c=wall_c, c0=c0)
    return spec, kwargs, info


def heated_cavity(n: int = 26, ny: int = 1, ra: float = 1e3,
                  pr: float = 0.71, tau: float = 0.66,
                  dT: float = 1.0):
    """Differentially heated square cavity (de Vahl Davis 1983): hot
    wall x=0 (+dT/2), cold wall x=n-1 (-dT/2), adiabatic top/bottom
    (z), thin periodic y (exact 2D dynamics at ny=1), gravity -z.
    Benchmark mean Nusselt numbers: Ra=1e3 -> 1.118, 1e4 -> 2.243,
    1e5 -> 4.519 (Pr = 0.71, air). Initial temperature: the linear
    conduction profile (the convection develops from it)."""
    H = n - 2
    tau_g, b, info = _derive(tau, pr, ra, dT, H)
    mask = np.full((n, ny, n), int(CellType.FLUID), np.int32)
    mask[0, :, :] = int(CellType.WALL)
    mask[-1, :, :] = int(CellType.WALL)
    mask[:, :, 0] = int(CellType.WALL)
    mask[:, :, -1] = int(CellType.WALL)
    wall_c = np.full((n, ny, n), np.nan, np.float32)
    wall_c[0, :, :] = +0.5 * dT
    wall_c[-1, :, :] = -0.5 * dT
    x = np.arange(n, dtype=np.float64)
    lin = 0.5 * dT - dT * np.clip((x - 0.5) / H, 0.0, 1.0)
    c0 = np.broadcast_to(
        lin[:, None, None].astype(np.float32), (n, ny, n)).copy()
    spec = CaseSpec(name="heated_cavity", shape=(n, ny, n), tau=tau,
                    units=_UNITS, mask=mask, boundaries=[])
    kwargs = dict(tau_g=tau_g, buoyancy=(0.0, 0.0, b), c_ref=0.0,
                  wall_c=wall_c, c0=c0)
    return spec, kwargs, info


def heated_cavity_3d(n: int = 32, ra: float = 1e4, pr: float = 0.71,
                     tau: float = 0.66, dT: float = 1.0):
    """Differentially heated CUBICAL cavity (Tric, Labrosse & Betrouni
    2000): hot wall x=0 (+dT/2), cold wall x=n-1 (-dT/2), the four
    remaining walls rigid and adiabatic, gravity -z. Unlike the
    quasi-2D `heated_cavity` (periodic y), every boundary layer is
    non-fluid, as lbm_tpu's Pallas kernels need; the at-scale 3D
    thermal configuration. Benchmark mean Nusselt numbers on the hot
    wall (spectral, Pr = 0.71): Ra=1e3 -> 1.0700, 1e4 -> 2.0542,
    1e5 -> 4.3370, 1e6 -> 8.6407."""
    H = n - 2
    tau_g, b, info = _derive(tau, pr, ra, dT, H)
    mask = np.full((n, n, n), int(CellType.FLUID), np.int32)
    for a in range(3):
        idx0 = [slice(None)] * 3
        idx0[a] = 0
        idx1 = [slice(None)] * 3
        idx1[a] = -1
        mask[tuple(idx0)] = int(CellType.WALL)
        mask[tuple(idx1)] = int(CellType.WALL)
    wall_c = np.full((n, n, n), np.nan, np.float32)
    wall_c[0, :, :] = +0.5 * dT
    wall_c[-1, :, :] = -0.5 * dT
    x = np.arange(n, dtype=np.float64)
    lin = 0.5 * dT - dT * np.clip((x - 0.5) / H, 0.0, 1.0)
    c0 = np.broadcast_to(
        lin[:, None, None].astype(np.float32), (n, n, n)).copy()
    spec = CaseSpec(name="heated_cavity_3d", shape=(n, n, n), tau=tau,
                    units=_UNITS, mask=mask, boundaries=[])
    kwargs = dict(tau_g=tau_g, buoyancy=(0.0, 0.0, b), c_ref=0.0,
                  wall_c=wall_c, c0=c0)
    return spec, kwargs, info


def rayleigh_benard_3d(nx: int = 64, ny: int = 64, nz: int = 34,
                       ra: float = 1e4, pr: float = 1.0,
                       tau: float = 0.8, dT: float = 1.0,
                       perturb: float = 1e-3, seed: int = 0):
    """3D Rayleigh-Benard BOX: isothermal rigid plates below (hot) and
    above (cold), rigid ADIABATIC side walls (a physical box; the
    laterally periodic slab is rayleigh_benard). Wide aspect
    ratios (nx, ny >> nz) approach the unbounded Ra_c = 1708; the
    conduction profile is seeded with small random thermal noise so no
    planform is imposed."""
    H = nz - 2
    tau_g, b, info = _derive(tau, pr, ra, dT, H)
    mask = np.full((nx, ny, nz), int(CellType.FLUID), np.int32)
    mask[0, :, :] = int(CellType.WALL)
    mask[-1, :, :] = int(CellType.WALL)
    mask[:, 0, :] = int(CellType.WALL)
    mask[:, -1, :] = int(CellType.WALL)
    mask[:, :, 0] = int(CellType.WALL)
    mask[:, :, -1] = int(CellType.WALL)
    wall_c = np.full((nx, ny, nz), np.nan, np.float32)
    wall_c[:, :, 0] = +0.5 * dT
    wall_c[:, :, -1] = -0.5 * dT
    # side plates stay adiabatic (NaN) — they are rigid walls only
    wall_c[0, :, :] = np.nan
    wall_c[-1, :, :] = np.nan
    wall_c[:, 0, :] = np.nan
    wall_c[:, -1, :] = np.nan
    z = np.arange(nz, dtype=np.float64)
    lin = 0.5 * dT - dT * np.clip((z - 0.5) / H, 0.0, 1.0)
    zi = np.clip((z - 0.5) / H, 0.0, 1.0)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((nx, ny, 1)) * np.sin(np.pi * zi)[None,
                                                                  None, :]
    c0 = (lin[None, None, :] + perturb * dT * noise).astype(np.float32)
    spec = CaseSpec(name="rayleigh_benard_3d", shape=(nx, ny, nz),
                    tau=tau, units=_UNITS, mask=mask, boundaries=[])
    kwargs = dict(tau_g=tau_g, buoyancy=(0.0, 0.0, b), c_ref=0.0,
                  wall_c=wall_c, c0=c0)
    return spec, kwargs, info


__all__ = ["rayleigh_benard", "heated_cavity", "heated_cavity_3d",
           "rayleigh_benard_3d"]
