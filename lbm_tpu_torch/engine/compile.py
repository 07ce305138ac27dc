"""Compile a CaseSpec into device tensors and precomputed boundary tables
(torch port of lbm_tpu/engine/compile.py, BGK slice).

Tables are built on the host in NumPy exactly as lbm_tpu builds them,
then moved to the device once:

  - `nbr_wall[i] = roll(mask == WALL, e_i)`: cells whose pull source in
    direction i is a wall (half-way bounce-back takes the cell's own
    opposite population instead). Only the dense step reads it; the
    CUDA kernel tests the int8 mask directly.
  - per NEE boundary, on its one-cell-thick consumer plane: the (D, A, B)
    `valid` bytes and the (D, A, B) fp32 `phi_star` equilibria, with D the
    directions the plane prescribes and (A, B) its lateral extent.
  - `velsum_offset`/`usq_offset`: the constant residual contribution of
    non-fluid cells, which hold their initial state forever.

What this slice does not carry raises NotImplementedError naming the
ROADMAP item that ports it; nothing falls back silently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import D3Q19
from lbm_tpu_torch.engine.spec import CaseSpec, PlaneBC
from lbm_tpu_torch.geometry.mask import CellType

_W64 = np.array([1.0 / 3.0] + [1.0 / 18.0] * 6 + [1.0 / 36.0] * 12,
                dtype=np.float64)

# Most boundaries the CUDA kernel takes in one launch (a fixed-size array
# of descriptors passed by value).
MAX_BCS = 4


def _phi_np(u: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Host-side fp32 phi for the static boundary equilibria:
    u (3, A, B) -> (D, A, B), the same expression as lbm_tpu's."""
    e = D3Q19.E[dirs].astype(np.float32)
    w = _W64[dirs].astype(np.float32)
    u = u.astype(np.float32)
    cu = np.tensordot(e, u, axes=([1], [0]))
    usq = np.sum(u * u, axis=0)
    return (w[:, None, None] * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
            ).astype(np.float32)


def _lat_axes(axis: int) -> tuple[int, int]:
    return tuple(a for a in range(3) if a != axis)  # type: ignore


def _shift_lat(arr: np.ndarray, e_lat: tuple[int, int]) -> np.ndarray:
    """Pull-shift on the last two (lateral) axes: value at x - e -> x."""
    return np.roll(arr, shift=e_lat, axis=(-2, -1))


@dataclasses.dataclass
class CompiledBC:
    """Runtime data for one PlaneBC, on its consumer plane."""

    axis: int
    consumer_coord: int
    dirs: tuple[int, ...]            # direction indices the plane sets
    valid: torch.Tensor              # (D, A, B) bool
    rho_fixed: Optional[float]       # None => extrapolate rho_F
    u_mode: str                      # 'fixed' | 'field' | 'extrapolate'
    phi_star: Optional[torch.Tensor]  # (D, A, B) f32; None if extrapolate
    omega: float                     # 1 - 1/tau, composed in fp32


@dataclasses.dataclass
class CompiledCase:
    name: str
    shape: tuple[int, int, int]
    tau: float
    device: torch.device
    mask: torch.Tensor               # (X, Y, Z) int8 labels
    fluid: torch.Tensor              # (X, Y, Z) bool
    nbr_wall: torch.Tensor           # (19, X, Y, Z) bool
    bcs: list[CompiledBC]
    rho0: torch.Tensor               # (X, Y, Z) f32 (init / non-fluid macro)
    u0: torch.Tensor                 # (3, X, Y, Z) f32
    velsum_offset: float
    usq_offset: float
    spec: CaseSpec


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to lbm_tpu_torch yet (ROADMAP.md {item})")


def check_supported(spec: CaseSpec) -> None:
    """Raise NotImplementedError for every spec feature this slice lacks."""
    if spec.collision != "bgk":
        _refuse(f"collision={spec.collision!r}",
                "Queue 1 item 7, kernel branch K1b")
    if spec.force is not None:
        _refuse("a body force (CaseSpec.force)",
                "Queue 1 item 7, kernel branch K1b")
    if spec.smagorinsky_cs is not None or spec.rheology is not None:
        _refuse("a per-cell tau closure (LES / rheology)",
                "Queue 1 item 7, kernel branch K1b")
    if spec.wall_velocity is not None:
        _refuse("moving walls (CaseSpec.wall_velocity)",
                "Queue 1 item 7, kernel branch K1b")
    if spec.wall_sdf is not None:
        _refuse("Bouzidi curved walls (CaseSpec.wall_sdf)",
                "Queue 1 item 8")
    for bc in spec.boundaries:
        if bc.windkessel is not None:
            _refuse("windkessel outlets (PlaneBC.windkessel)",
                    "Queue 1 item 8")
        if bc.u_mode == "series":
            _refuse("u_mode='series' boundaries", "Queue 1 item 6")
        if bc.axis == 2:
            _refuse("NEE boundaries on z planes", "Queue 1 item 6")
    if len(spec.boundaries) > MAX_BCS:
        _refuse(f"more than {MAX_BCS} NEE boundaries", "Queue 1 item 6")
    for a, n in enumerate(spec.shape):
        if n < 3:
            raise ValueError(f"axis {a} has {n} cells; the step needs >= 3")


def compile_bc(bc: PlaneBC, mask: np.ndarray, tau: float,
               device) -> CompiledBC:
    dirs = D3Q19.dirs_into(bc.axis, bc.normal)
    lat = _lat_axes(bc.axis)
    plane_mask = np.take(mask, bc.coord, axis=bc.axis) == bc.mask_value
    e_lats = [tuple(int(D3Q19.E[i][a]) for a in lat) for i in dirs]
    valid = np.stack([_shift_lat(plane_mask, el) for el in e_lats])

    phi_star = None
    if bc.u_mode in ("fixed", "field"):
        if bc.u_mode == "fixed":
            a, b = plane_mask.shape
            u_star = np.broadcast_to(
                np.asarray(bc.u_value, np.float32)[:, None, None], (3, a, b))
        else:
            u_star = bc.u_field
        phi_star = np.stack([
            _phi_np(_shift_lat(u_star, el), dirs[d : d + 1])[0]
            for d, el in enumerate(e_lats)
        ])
    return CompiledBC(
        axis=bc.axis,
        consumer_coord=bc.coord + bc.normal,
        dirs=tuple(int(i) for i in dirs),
        valid=torch.from_numpy(np.ascontiguousarray(valid)).to(device),
        rho_fixed=(float(bc.rho_value) if bc.rho_mode == "fixed" else None),
        u_mode=bc.u_mode,
        phi_star=(None if phi_star is None
                  else torch.from_numpy(phi_star).to(device)),
        # fp32-compose like the reference's (1.0f - 1.0f/tau)
        omega=float(np.float32(1.0) - np.float32(1.0) / np.float32(tau)),
    )


def neighbor_wall(mask: np.ndarray) -> np.ndarray:
    """(19, X, Y, Z) bool: nbr_wall[i][x] = mask[x - e_i] == WALL, wrapped."""
    wall = mask == CellType.WALL
    out = np.zeros((D3Q19.Q,) + mask.shape, dtype=bool)
    for i in range(1, D3Q19.Q):
        ex, ey, ez = (int(v) for v in D3Q19.E[i])
        out[i] = np.roll(wall, shift=(ex, ey, ez), axis=(0, 1, 2))
    return out


def canonical_device(device) -> torch.device:
    """torch.device(device) with the CUDA index filled in, so it compares
    equal to the .device of tensors made on it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def compile_case(spec: CaseSpec, device="cpu") -> CompiledCase:
    check_supported(spec)
    device = canonical_device(device)
    mask = np.asarray(spec.mask)
    if mask.size and (mask.min() < -128 or mask.max() > 127):
        raise ValueError("mask labels must fit int8")
    fluid = mask == CellType.FLUID
    u0 = np.asarray(spec.u0, np.float32)
    rho0 = np.asarray(spec.rho0, np.float32)
    nonfluid = ~fluid
    speed0 = np.sqrt(np.sum(u0.astype(np.float64) ** 2, axis=0))
    return CompiledCase(
        name=spec.name,
        shape=tuple(int(s) for s in spec.shape),
        tau=float(spec.tau),
        device=device,
        mask=torch.from_numpy(mask.astype(np.int8)).to(device),
        fluid=torch.from_numpy(fluid).to(device),
        nbr_wall=torch.from_numpy(neighbor_wall(mask)).to(device),
        bcs=[compile_bc(bc, mask, spec.tau, device) for bc in spec.boundaries],
        rho0=torch.from_numpy(np.ascontiguousarray(rho0)).to(device),
        u0=torch.from_numpy(np.ascontiguousarray(u0)).to(device),
        velsum_offset=float(np.sum(speed0[nonfluid], dtype=np.float64)),
        usq_offset=float(np.sum(speed0[nonfluid] ** 2, dtype=np.float64)),
        spec=spec,
    )


__all__ = ["CompiledBC", "CompiledCase", "compile_case", "compile_bc",
           "canonical_device", "check_supported", "neighbor_wall", "MAX_BCS"]
