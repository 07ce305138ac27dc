"""Declarative case specification: the same PlaneBC and CaseSpec fields as
lbm_tpu/engine/spec.py, so a spec carries across as a field copy
(bridge.case_from_reference).

The fields this port does not run yet (collision != 'bgk', force,
closures, curved or moving walls, series and windkessel boundaries,
z-plane boundaries) are kept so specs stay interchangeable;
engine/compile.compile_case refuses them by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lbm_tpu_torch.core.units import UnitSystem
from lbm_tpu_torch.geometry.mask import CellType


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass
class PlaneBC:
    """A non-equilibrium-extrapolation (NEE) boundary on an axis plane.

    For direction i with e_i . n > 0 (n = inward normal) and fluid
    neighbor F = b + e_i:
        f_i(b) = feq_i(rho*, u*) + (f_i(F) - feq_i(rho_F, u_F)) (1 - 1/tau)
    rho* is extrapolated (rho_F) or fixed; u* is fixed, a lateral field,
    extrapolated (u_F), or a per-step series.
    """

    mask_value: int          # cell label this BC applies to (2, 3, 5, ...)
    axis: int                # 0=x, 1=y, 2=z
    coord: int               # plane index along `axis`
    normal: int              # +1/-1: inward normal direction (into fluid)
    rho_mode: str = "extrapolate"    # 'extrapolate' | 'fixed'
    rho_value: float = 1.0
    u_mode: str = "fixed"            # 'fixed' | 'field' | 'extrapolate' | 'series'
    u_value: tuple[float, float, float] = (0.0, 0.0, 0.0)
    u_field: Optional[np.ndarray] = None    # (3, A, B) lateral field
    u_series: Optional[np.ndarray] = None   # (T, 3, A, B) per-step fields
    u_series_stride: int = 1                # steps per series phase
    windkessel: Optional[tuple[float, float, float]] = None  # (Rp, C, Rd)
    windkessel_p0: float = 0.0              # initial P_c (lattice gauge)

    def __post_init__(self):
        _require(self.axis in (0, 1, 2), f"axis must be 0, 1 or 2: {self.axis}")
        _require(self.normal in (-1, 1), f"normal must be +-1: {self.normal}")
        _require(self.rho_mode in ("extrapolate", "fixed"),
                 f"unknown rho_mode {self.rho_mode!r}")
        _require(self.u_mode in ("fixed", "field", "extrapolate", "series"),
                 f"unknown u_mode {self.u_mode!r}")
        if self.u_mode == "field":
            _require(self.u_field is not None and self.u_field.ndim == 3,
                     "u_mode='field' needs a (3, A, B) u_field")
        if self.u_mode == "series":
            _require(self.u_series is not None and self.u_series.ndim == 4,
                     "u_mode='series' needs a (T, 3, A, B) u_series")
        if self.windkessel is not None:
            self.windkessel = tuple(float(v) for v in self.windkessel)
            rp, cap, rd = self.windkessel
            _require(rp >= 0.0 and cap > 0.0 and rd > 0.0,
                     "windkessel needs Rp >= 0, C > 0, Rd > 0")
            _require(self.rho_mode == "fixed",
                     "windkessel couples to a pressure outlet "
                     "(rho_mode='fixed')")


@dataclasses.dataclass
class CaseSpec:
    name: str
    shape: tuple[int, int, int]
    tau: float
    units: UnitSystem
    mask: np.ndarray                     # (nx, ny, nz) int labels
    boundaries: list[PlaneBC]
    rho0: Optional[np.ndarray] = None    # (nx, ny, nz); default 1
    u0: Optional[np.ndarray] = None      # (3, nx, ny, nz); default 0
    # Run policy: max steps, chunk length, velsum tolerance and the
    # number of sub-tolerance steps that stops a run.
    max_steps: int = 10000
    time_save: int = 500
    tol: float = 1e-6
    stag_max: int = 50
    collision: str = "bgk"               # 'bgk' | 'trt' | 'mrt'
    magic_lambda: float = 0.1875         # TRT magic parameter
    mrt_rates: Optional[dict] = None
    smagorinsky_cs: Optional[float] = None
    rheology: Optional[dict] = None
    force: Optional[tuple[float, float, float]] = None
    wall_sdf: Optional[np.ndarray] = None
    wall_velocity: Optional[tuple[float, float, float]] = None
    residual_flavor: str = "velsum"      # 'velsum' | 'usq'
    usq_includes_outlet_labels: bool = True
    vtk_crops: tuple[int, int, int] = (2, 2, 2)
    vtk_density: bool = False
    vtk_origin_offset: int = 0

    def __post_init__(self):
        _require(self.mask.shape == tuple(self.shape),
                 f"mask shape {self.mask.shape} != shape {self.shape}")
        _require(self.collision in ("bgk", "trt", "mrt"),
                 f"unknown collision {self.collision!r}")
        _require(self.residual_flavor in ("velsum", "usq"),
                 f"unknown residual_flavor {self.residual_flavor!r}")
        if self.force is not None:
            self.force = tuple(float(c) for c in self.force)
            _require(len(self.force) == 3, "force is a 3-vector")
        has_moving = bool((self.mask == int(CellType.MOVING)).any())
        if self.wall_velocity is not None:
            self.wall_velocity = tuple(float(c) for c in self.wall_velocity)
            _require(has_moving, "wall_velocity set but no MOVING cells")
        else:
            _require(not has_moving, "MOVING cells need wall_velocity")
        if self.rho0 is None:
            self.rho0 = np.ones(self.shape, np.float32)
        if self.u0 is None:
            self.u0 = np.zeros((3,) + tuple(self.shape), np.float32)


__all__ = ["PlaneBC", "CaseSpec"]
