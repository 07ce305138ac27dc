"""What the plain reference steps: a box of cell labels, its initial
macroscopic fields and its boundary planes, built from a configuration's
parameters by the case's own module (reference/cases/<case>.py, found by
the case's name).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import numpy as np

from lbm_bench.reference.lattice import E, FLUID, Q, WALL


@dataclasses.dataclass
class Plane:
    """A non-equilibrium-extrapolation boundary: the cells labelled
    `label` on the plane `coord` of `axis`, prescribing the directions
    with e[axis] == normal on the next plane inward.

    rho: 'fixed' (rho_value) or 'extrapolate'; u: 'fixed' (u_value),
    'extrapolate' or 'series' (series: (T, 3) velocities, phase (t //
    stride) % T). windkessel: (Rp, C, Rd) of an RCR outlet, whose rho* is
    rho_value + 3 (Q Rp + P_c') from its carried P_c (initially p0)."""

    label: int
    axis: int
    coord: int
    normal: int
    rho: str = "extrapolate"
    rho_value: float = 1.0
    u: str = "fixed"
    u_value: tuple = (0.0, 0.0, 0.0)
    series: Optional[np.ndarray] = None
    stride: int = 1
    windkessel: Optional[tuple] = None
    p0: float = 0.0

    @property
    def dirs(self) -> list[int]:
        return [i for i in range(Q) if int(E[i, self.axis]) == self.normal]


@dataclasses.dataclass
class Geometry:
    shape: tuple
    mask: np.ndarray            # (X, Y, Z) int32 labels
    u0: np.ndarray              # (3, X, Y, Z) float32, before the seed's
    tau: float
    planes: list
    residual: str               # 'velsum' or 'usq'

    @property
    def fluid(self) -> np.ndarray:
        return self.mask == FLUID

    @property
    def wall(self) -> np.ndarray:
        return self.mask == WALL

    @property
    def n_live(self) -> int:
        """Non-DEAD cells: the lattice sites a step updates, the
        reference's NLATTICE."""
        return int(np.count_nonzero(self.mask))


def build(case: str, params: dict) -> Geometry:
    """The geometry of `case` (reference/cases/<case>.py) at `params`."""
    mod = importlib.import_module(f"lbm_bench.reference.cases.{case}")
    return mod.build(**params)
