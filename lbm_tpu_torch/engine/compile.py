"""Compile a CaseSpec into device tensors and precomputed boundary tables
(torch port of lbm_tpu/engine/compile.py).

Tables are built on the host in NumPy exactly as lbm_tpu builds them,
then moved to the device once:

  - `nbr_wall[i] = roll(mask == WALL, e_i)`: cells whose pull source in
    direction i is a wall (half-way bounce-back takes the cell's own
    opposite population instead). Only the dense step reads it; the
    CUDA kernel tests the int8 mask directly.
  - per NEE boundary, on its one-cell-thick consumer plane: the (D, A, B)
    `valid` bytes and the (D, A, B) fp32 `phi_star` equilibria (or the
    (T, D, A, B) `phi_star_series` of a u_mode='series' boundary, phase
    (t // series_stride) % T at step t), with D the directions the plane
    prescribes and (A, B) its lateral extent;
  - per z-plane boundary, the static (x0, x1, y0, y1) window around its
    valid consumer cells (lbm_tpu's `_valid_bbox`, whose windowed fixup
    runs after its kernel): the collide-stream kernel applies z planes in
    its own pass, and the window checks that this is the dense step's
    order (`check_z_windows`) and bounds the plain fixup's recompute;
  - `live_blocks`: ids of the 256-cell blocks that hold a non-DEAD cell
    (lbm_tpu's `live_tile_ids`), or None when skipping would not pay
    (SKIP_BELOW, measured on the H100): the scalar kernel's launch list;
    `fluid_cells`, the ascending ids of the fluid cells, beside it (None
    with it): the collide-stream kernel's launch list, a thread a fluid
    cell (a case with windkessel outlets always has one, its outlets'
    footprint cells first: `fold_cell_ids`); `fluid_pairs`, built at
    first use for every case, the ascending ids of the aligned z pairs
    that hold a fluid cell (`fluid_pair_ids`), and `pair_launch`, the
    bf16 kernel's list: the interior pairs (`pair_interior_bits`) first,
    a thread a pair, then the other pairs' fluid cells, a thread a cell;
    `fluid_launch`, built at first use, the fp32 kernel's launch over the
    same cells (`fluid_launch_tables`: each row's fluid runs in
    sector-aligned segments, a word of wall links a lane), which replaces
    `fluid_cells` there; `live_tiles`, built at first
    use, the ids of the fused pair's
    units (an x segment of a (y, z) column tile, TILE) under the same
    rule;
  - `velsum_offset`/`usq_offset`: the constant residual contribution of
    non-fluid cells, which hold their initial state forever;
  - the collision branch: `tau_minus` (TRT), the MRT matrices `mrt_k`/
    `mrt_kf`, the per-cell tau `closure` (LES / rheology), the Guo
    `force`, the MOVING walls' `wall_velocity` and, built at first use
    for the dense step, `nbr_moving`.

A windkessel (RCR) outlet (PlaneBC.windkessel) keeps its (Rp, C, Rd),
its initial P_c, the (A, B) fp32 `flow_weight` footprint of its label on
its plane and `flow_sign` = -normal (lbm_tpu's flux Q = flow_sign *
sum(flow_weight * u_prev[axis]) over the consumer plane; `wk_footprint`
lists its cells), its index in the carried P_c vector (`wk_index`,
`wk_init`'s order). On a z plane
its window holds its footprint too (lbm_tpu's `_valid_bbox`); on an x/y
plane it may share no consumer cell with another boundary
(`check_z_windows`), so the collide-stream kernel may apply it in its own
pass, in boundary order.

Bouzidi curved walls (CaseSpec.wall_sdf): `bouzidi`, what the dense step
reads in place of lbm_tpu's (19, X, Y, Z) CompiledCase.link_q: the links
(fluid cells whose pull source is a wall) as flat ids into the (19, X, Y,
Z) state and their three fp32 coefficients, computed once from the links'
q (core/bouzidi.link_q) as lbm_tpu's step computes them
(core/bouzidi.flat_links), built at first use on the case's device. The
collide-stream kernels carry no q planes: `kernel_refusal` names them,
with the two compositions the kernel lacks, and the cases the fused pair
of steps refuses are named by `fuse2_refusal`. Nothing falls back
silently.

`compile_shard` compiles one rank's window of a case split along one
lattice axis into `world` shards (the counterpart of lbm_tpu's
parallel/pallas_sharded.py windowing): a ShardCase with the rank's rows
of every table, the two neighbour rows' labels (static, so never
exchanged) and the rank's own residual offsets.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from lbm_tpu_torch.core.bouzidi import flat_links, link_q, link_table
from lbm_tpu_torch.core.lattice import D3Q19
from lbm_tpu_torch.core.mrt import mrt_matrices
from lbm_tpu_torch.core.rheology import normalize_closure
from lbm_tpu_torch.engine.spec import CaseSpec, PlaneBC
from lbm_tpu_torch.geometry.mask import CellType

_W64 = np.array([1.0 / 3.0] + [1.0 / 18.0] * 6 + [1.0 / 36.0] * 12,
                dtype=np.float64)

# Most x/y-plane and z-plane boundaries the collide-stream kernel takes in
# one launch (kMaxBCs in kernels/csrc/d3q19.cuh and kMaxZBCs in
# collide_stream.cuh: two fixed-size descriptor arrays passed by value,
# the z planes' walked by a loop of their own). The fused pair takes x/y
# planes only, MAX_BCS.
MAX_BCS = 4
MAX_Z_BCS = 8
# Cells per block of the collide-stream and scalar kernels (kBlock in
# kernels/csrc/d3q19.cuh): the unit of the live-block list.
BLOCK = 256
# Launch over the live lists (the scalar kernel's live blocks, the
# collide-stream kernel's fluid cells) only when fewer than this share of
# the blocks is live. The lid cavity at 64^3 and up (97-98% live) keeps
# the full launch: on an H100 its fluid list took 1.39 ms a step at 256^3
# against 1.09 over every cell (PERF.md).
SKIP_BELOW = 0.95
# The fused pair's unit, the unit of its live list: an x segment of
# TILE[0] planes of a TILE[1] x TILE[2] (y, z) column tile (kSeg, kTY and
# kTZ in kernels/csrc/collide_stream2.cuh).
TILE = (64, 8, 32)
# The fp32 collide-stream kernel's launch over the fluid cells
# (FluidLaunch): segments of SEG cells of one (x, y) row, aligned to SEG
# in the flattened cell id (kSegLanes in kernels/csrc/
# collide_stream_list.cuh: 32 bytes of fp32 a direction, one sector); a
# lane's word: LANE_IDLE (bit 0) for a cell of the row that is not fluid,
# LANE_OUT (every bit) for one outside the row (kIdle, kOut there).
SEG = 8
LANE_IDLE = 1
LANE_OUT = -1


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
    u_mode: str                      # 'fixed' | 'field' | 'extrapolate' | 'series'
    phi_star: Optional[torch.Tensor]  # (D, A, B) f32 for 'fixed'/'field'
    omega: float                     # 1 - 1/tau, composed in fp32
    phi_star_series: Optional[torch.Tensor] = None  # (T, D, A, B) f32
    series_stride: int = 1           # steps per series phase
    window: Optional[tuple[int, int, int, int]] = None  # z planes: x0 x1 y0 y1
    # Windkessel (RCR) coupling: the rewrite's rho* = rho_fixed + 3 (Q Rp
    # + P_c') with P_c the carried state (engine/step.windkessel_update)
    windkessel: Optional[tuple[float, float, float]] = None  # (Rp, C, Rd)
    wk_p0: float = 0.0               # initial P_c
    flow_weight: Optional[torch.Tensor] = None  # (A, B) f32 footprint
    flow_sign: float = 0.0           # -normal (outward flux positive)
    wk_index: Optional[int] = None   # slot in the carried P_c vector

    def phi_star_at(self, t: int) -> Optional[torch.Tensor]:
        """The (D, A, B) phi* table in force at step t (None for
        'extrapolate', whose phi* is the neighbor's own phi)."""
        if self.u_mode != "series":
            return self.phi_star
        return self.phi_star_series[self.series_phase(t)]

    def series_phase(self, t: int) -> int:
        return (int(t) // self.series_stride) % self.phi_star_series.shape[0]


def tau_minus_of(spec: CaseSpec) -> Optional[float]:
    """TRT odd-moment relaxation time from the magic parameter, or None
    when the collision is not TRT: tau_minus = 1/2 + Lambda / (tau -
    1/2)."""
    if spec.collision != "trt":
        return None
    return 0.5 + spec.magic_lambda / (spec.tau - 0.5)


def mrt_of(spec: CaseSpec):
    """(K, KF) f32 (19, 19) matrices for collision='mrt', else (None,
    None)."""
    if spec.collision != "mrt":
        return None, None
    k, kf = mrt_matrices(spec.tau, spec.mrt_rates)
    return k.astype(np.float32), kf.astype(np.float32)


CURVED_REFUSAL = ("backend='kernel' does not support wall_sdf (Bouzidi "
                  "curved walls) — use backend='dense' or 'sparse'")


def kernel_refusal(spec: CaseSpec, field: bool = False) -> Optional[str]:
    """Why the collide-stream kernel refuses this case, or None: Bouzidi
    curved walls (no q planes; lbm_tpu's Pallas kernel refuses them in
    these words, with its backend names), and two compositions: its MRT
    has no moment-space source KF and its closures no variable-rate Guo
    prefactor; the dense step runs both (lbm_tpu's kernel refuses the
    same two). field: the step also takes a per-cell Boussinesq force
    (the thermal route), which the kernel composes with BGK and TRT only
    and not with a CaseSpec.force, as lbm_tpu's."""
    if spec.wall_sdf is not None:
        return CURVED_REFUSAL
    dense = "; run this case with backend='dense'"
    if field and spec.force is not None:
        return ("the force-field kernel carries no constant base force "
                "beside the Boussinesq field (CaseSpec.force)" + dense)
    if spec.force is None and not field:
        return None
    what = "the Boussinesq force field" if field else "a body force"
    if spec.collision == "mrt":
        return (f"MRT + {what} needs the moment-space Guo source (KF) "
                "that the collide-stream kernel does not carry" + dense)
    if spec.smagorinsky_cs is not None or spec.rheology is not None:
        return (f"a per-cell tau closure (LES / rheology) + {what} "
                "needs the variable-rate Guo prefactor that the "
                "collide-stream kernel lacks" + dense)
    return None


def fuse2_refusal(spec: CaseSpec, lowmem: bool = False) -> Optional[str]:
    """Why two fused steps per launch (fuse=2) cannot run this case, or
    None, in lbm_tpu's words (engine/runner.py, make_pallas_step). The
    pair applies only x/y-plane boundaries: a z-plane (or windkessel)
    boundary's fixup runs after the bulk step and cannot sit between
    the two. lowmem stays on the single-step path, as lbm_tpu's (whose
    lowmem aliases the state in place, which it wires for fuse=1 only).
    The pair has no force-field instance, as lbm_tpu's has not."""
    if any(b.axis not in (0, 1) or b.windkessel is not None
           for b in spec.boundaries):
        return ("fuse=2 requires a single-chip run with all NEE boundaries "
                "on x/y planes")
    if lowmem:
        return ("lowmem is only wired on the single-call fuse=1 path "
                "(lbm_tpu's in_place aliasing)")
    return None


@dataclasses.dataclass(eq=False)  # hashed by identity: a weak-dict key
class CompiledCase:
    name: str
    shape: tuple[int, int, int]
    tau: float
    device: torch.device
    mask: torch.Tensor               # (X, Y, Z) int8 labels
    fluid: torch.Tensor              # (X, Y, Z) bool
    bcs: list[CompiledBC]
    rho0: torch.Tensor               # (X, Y, Z) f32 (init / non-fluid macro)
    u0: torch.Tensor                 # (3, X, Y, Z) f32
    velsum_offset: float
    usq_offset: float
    spec: CaseSpec
    live_blocks: Optional[torch.Tensor] = None  # (n,) int32 block ids
    fluid_cells: Optional[torch.Tensor] = None  # (n,) int32 cell ids
    tau_minus: Optional[float] = None  # TRT odd rate; None => not TRT
    mrt_k: Optional[np.ndarray] = None   # (19, 19) f32; None => not MRT
    mrt_kf: Optional[np.ndarray] = None  # (19, 19) f32 Guo prefactor
    closure: Optional[tuple] = None  # core/rheology.normalize_closure
    force: Optional[tuple[float, float, float]] = None  # Guo body force
    wall_velocity: Optional[tuple[float, float, float]] = None  # MOVING

    @functools.cached_property
    def nbr_wall(self) -> torch.Tensor:
        """(19, X, Y, Z) bool, built at first use: only the dense step
        reads it (600 MB at the full-size coronary)."""
        return torch.from_numpy(neighbor_wall(np.asarray(self.spec.mask))
                                ).to(self.device)

    @functools.cached_property
    def nbr_moving(self) -> Optional[torch.Tensor]:
        """(19, X, Y, Z) bool, nbr_moving[i][x] = mask[x - e_i] ==
        MOVING, built at first use by the dense step; None without moving
        walls. The CUDA kernels test the int8 mask directly."""
        if self.wall_velocity is None:
            return None
        return torch.from_numpy(neighbor_wall(np.asarray(self.spec.mask),
                                              CellType.MOVING)
                                ).to(self.device)

    @functools.cached_property
    def pair_interior(self) -> torch.Tensor:
        """The bf16 kernel's interior-pair bits (pair_interior_bits of
        the mask and every boundary's consumer plane), int32 words on the
        device, built at first use."""
        return pair_interior_bits(
            self.mask, [(bc.axis, bc.consumer_coord) for bc in self.bcs])

    @functools.cached_property
    def fluid_launch(self) -> FluidLaunch:
        """fluid_launch_tables of the mask, in the moving walls' form when
        the case has them, built at first use on the device: the fp32
        collide-stream kernel's launch over the fluid cells."""
        return fluid_launch_tables(self.mask, self.wall_velocity is not None)

    @functools.cached_property
    def fluid_pairs(self) -> torch.Tensor:
        """fluid_pair_ids of the mask on the device, built at first use."""
        ids = fluid_pair_ids(np.asarray(self.spec.mask))
        return torch.from_numpy(ids).to(self.device)

    def pair_launch(self, streamed: bool) -> tuple[torch.Tensor, int]:
        """The bf16 kernel's launch list and how many entries at its head
        are pairs, built at first use for each form. streamed (a BGK or
        TRT instance without a closure): the interior pairs' ids
        (fluid_pairs whose pair_interior bit is set), ascending, then the
        fluid cells of every other pair, ascending; else (those instances
        collide a cell from all 19 of its populations at once) every
        fluid cell and 0. A thread takes one entry, so a warp holds one
        form: the lid 256^3 [bgk+bf16] launch over the box, a thread a
        pair whichever its form, took 0.92 ms against its interior pairs'
        0.60 alone on the H100, for every z row there starts and ends with
        a pair beside a wall; this form took 0.87 (probes/quad_cells.py,
        probes/bf16_k1_ab.py). A list without an entry holds cell 0, which
        the kernel skips unless it is fluid."""
        lists = self.__dict__.setdefault("_pair_launch", {})
        if streamed not in lists:
            fluid = self.mask.reshape(-1) == CellType.FLUID
            cells = torch.nonzero(fluid).reshape(-1).to(torch.int32)
            inner = cells[:0]
            if streamed:
                nz = self.shape[2]
                pair = (cells // nz) * -(-nz // 2) + (cells % nz) // 2
                cells = cells[~pair_bits_of(self.pair_interior, pair)]
                inner = self.fluid_pairs[pair_bits_of(self.pair_interior,
                                                      self.fluid_pairs)]
            if not len(inner) + len(cells):
                cells = cells.new_zeros(1)
            lists[streamed] = (torch.cat([inner, cells]), len(inner))
        return lists[streamed]

    @functools.cached_property
    def _link_table(self):
        return link_table(np.asarray(self.spec.mask), self.spec.wall_sdf)

    @functools.cached_property
    def bouzidi(self) -> Optional[tuple]:
        """What the dense step's Bouzidi branch reads, built at first use:
        core/bouzidi.flat_links of the links (fluid cells whose source x -
        e_i is a wall) over the flattened (19, X, Y, Z) state; None
        without CaseSpec.wall_sdf (or without a link)."""
        if self.spec.wall_sdf is None:
            return None
        return flat_links(self._link_table, int(np.prod(self.shape)),
                          self.device)

    @property
    def kernel_bcs(self) -> list[CompiledBC]:
        """The x/y-plane boundaries (those lbm_tpu's kernel rewrites in
        its rows, and the fused pair's)."""
        return [bc for bc in self.bcs if bc.axis != 2]

    @property
    def z_bcs(self) -> list[CompiledBC]:
        """The z-plane boundaries, in boundary order."""
        return [bc for bc in self.bcs if bc.axis == 2]

    @property
    def step_bcs(self) -> list[CompiledBC]:
        """The boundaries the collide-stream kernel applies, in boundary
        order: every x/y plane and every z plane with a window (one
        without has no valid consumer cell and rewrites nothing)."""
        return [bc for bc in self.bcs
                if bc.axis != 2 or bc.window is not None]

    @functools.cached_property
    def live_tiles(self) -> Optional[torch.Tensor]:
        """(n,) int32 ids of the fused pair's units (TILE) that hold a
        non-DEAD cell, or None when skipping would not pay (the same
        SKIP_BELOW rule as live_blocks); built at first use."""
        ids = live_tile_ids(np.asarray(self.spec.mask))
        n_tiles = int(np.prod([-(-n // t) for n, t in zip(self.shape, TILE)]))
        if len(ids) >= SKIP_BELOW * n_tiles:
            return None
        return torch.from_numpy(ids).to(self.device)


def wk_init(bcs) -> Optional[np.ndarray]:
    """(n_wk,) f32 initial windkessel P_c states in boundary order, or
    None without a windkessel outlet (lbm_tpu's wk_init)."""
    p0 = [float(b.wk_p0) for b in bcs if b.windkessel is not None]
    return np.asarray(p0, np.float32) if p0 else None


def has_windkessel(bcs) -> bool:
    return any(b.windkessel is not None for b in bcs)


def check_supported(spec: CaseSpec) -> None:
    """Raise NotImplementedError for a case beyond the collide-stream
    kernel's descriptor capacity, ValueError for an empty axis."""
    n_xy = sum(bc.axis != 2 for bc in spec.boundaries)
    n_z = len(spec.boundaries) - n_xy
    if n_xy > MAX_BCS or n_z > MAX_Z_BCS:
        raise NotImplementedError(
            f"{n_xy} NEE boundaries on x/y planes and {n_z} on z planes: "
            f"the collide-stream kernel takes at most {MAX_BCS} on x/y "
            f"planes and {MAX_Z_BCS} on z planes")
    for a, n in enumerate(spec.shape):
        if n < 1:  # one cell is a thin periodic slab: the pull wraps
            raise ValueError(f"axis {a} has {n} cells")


def compile_bc(bc: PlaneBC, mask: np.ndarray, tau: float,
               device, wk_index: Optional[int] = None) -> CompiledBC:
    dirs = D3Q19.dirs_into(bc.axis, bc.normal)
    lat = _lat_axes(bc.axis)
    plane_mask = np.take(mask, bc.coord, axis=bc.axis) == bc.mask_value
    e_lats = [tuple(int(D3Q19.E[i][a]) for a in lat) for i in dirs]
    valid = np.stack([_shift_lat(plane_mask, el) for el in e_lats])

    def phi_table(u_star):
        return np.stack([
            _phi_np(_shift_lat(u_star, el), dirs[d : d + 1])[0]
            for d, el in enumerate(e_lats)
        ])

    phi_star = phi_series = None
    if bc.u_mode == "fixed":
        a, b = plane_mask.shape
        phi_star = phi_table(np.broadcast_to(
            np.asarray(bc.u_value, np.float32)[:, None, None], (3, a, b)))
    elif bc.u_mode == "field":
        phi_star = phi_table(bc.u_field)
    elif bc.u_mode == "series":
        phi_series = np.stack([phi_table(u) for u in bc.u_series])

    def dev(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)

    weight = (plane_mask.astype(np.float32) if bc.windkessel is not None
              else None)
    return CompiledBC(
        axis=bc.axis,
        consumer_coord=bc.coord + bc.normal,
        dirs=tuple(int(i) for i in dirs),
        valid=torch.from_numpy(np.ascontiguousarray(valid)).to(device),
        rho_fixed=(float(bc.rho_value) if bc.rho_mode == "fixed" else None),
        u_mode=bc.u_mode,
        phi_star=dev(phi_star),
        # fp32-compose like the reference's (1.0f - 1.0f/tau)
        omega=float(np.float32(1.0) - np.float32(1.0) / np.float32(tau)),
        phi_star_series=dev(phi_series),
        series_stride=int(bc.u_series_stride),
        window=(valid_bbox(valid, plane_mask.shape, footprint=weight)
                if bc.axis == 2 else None),
        windkessel=(None if bc.windkessel is None
                    else tuple(float(v) for v in bc.windkessel)),
        wk_p0=float(bc.windkessel_p0),
        flow_weight=dev(weight),
        flow_sign=float(-bc.normal),
        wk_index=wk_index if bc.windkessel is not None else None,
    )


def compile_bcs(spec: CaseSpec, mask: np.ndarray, device) -> list:
    """Every boundary of the spec, in order, windkessel outlets numbered
    in that order (the carried P_c vector's)."""
    out, k = [], 0
    for bc in spec.boundaries:
        out.append(compile_bc(bc, mask, spec.tau, device, wk_index=k))
        k += bc.windkessel is not None
    return out


def valid_bbox(valid: np.ndarray, shape_xy, margin: int = 2,
               footprint: Optional[np.ndarray] = None):
    """Static (x0, x1, y0, y1) window around a z-plane boundary's valid
    consumer cells, `margin` cells wider on each side and clipped to the
    plane (lbm_tpu's `_valid_bbox`); None when no cell is valid. A
    windkessel outlet's flux footprint (its (A, B) flow_weight) joins the
    valid cells, as lbm_tpu unions it in."""
    v = np.asarray(valid).any(axis=0)
    if footprint is not None:
        v = v | (np.asarray(footprint) != 0)
    xs, ys = np.nonzero(v)
    if xs.size == 0:
        return None
    return (max(int(xs.min()) - margin, 0),
            min(int(xs.max()) + 1 + margin, shape_xy[0]),
            max(int(ys.min()) - margin, 0),
            min(int(ys.max()) + 1 + margin, shape_xy[1]))


def _consumers_on_plane(bc: CompiledBC, axis: int, coord: int,
                        shape) -> np.ndarray:
    """(A, B) bool over the lateral axes of `axis`: the cells of the plane
    `coord` along `axis` at which `bc` rewrites a population."""
    lat = _lat_axes(axis)
    out = np.zeros((shape[lat[0]], shape[lat[1]]), bool)
    v = bc.valid.cpu().numpy().any(axis=0)
    if bc.axis == axis:
        if bc.consumer_coord == coord:
            out |= v
        return out
    # the two planes meet on a line along the third axis
    line = np.take(v, coord, axis=_lat_axes(bc.axis).index(axis))
    idx = [slice(None), slice(None)]
    idx[lat.index(bc.axis)] = bc.consumer_coord
    out[tuple(idx)] = line
    return out


def check_z_windows(bcs: list[CompiledBC], shape) -> None:
    """The collide-stream kernel rewrites a cell with its x/y boundaries
    first, in boundary order, and its z-plane boundaries after them, and
    the plain fixup recomputes each z-plane boundary's window from the
    pre-step state with that boundary alone. Both equal the dense step,
    which applies every boundary in boundary order, only if the window
    covers the boundary's consumer cells and holds no cell that another
    boundary rewrites (lbm_tpu refuses the same cases). lbm_tpu fixes a
    windkessel outlet after its kernel, after the static x/y planes, so
    a windkessel plane on x or y may share no consumer cell with another
    boundary: then its place in the kernel's order changes nothing."""
    for k, bc in enumerate(bcs):
        c = bc.consumer_coord
        if bc.axis != 2:
            if bc.windkessel is None:
                continue
            own = _consumers_on_plane(bc, bc.axis, c, shape)
            for j, other in enumerate(bcs):
                if j != k and (own & _consumers_on_plane(
                        other, bc.axis, c, shape)).any():
                    raise ValueError(
                        f"boundary {j} rewrites consumer cells of windkessel "
                        f"boundary {k} on {'xy'[bc.axis]}={c}; lbm_tpu "
                        "fixes the windkessel plane after the others, the "
                        "kernel's pass in boundary order")
            continue
        if bc.window is None:
            continue
        x0, x1, y0, y1 = bc.window
        own = _consumers_on_plane(bc, 2, c, shape)
        if own.sum() != own[x0:x1, y0:y1].sum():
            raise AssertionError(f"z window {bc.window} misses consumer "
                                 f"cells of boundary {k}")
        for j, other in enumerate(bcs):
            if j == k:
                continue
            cells = _consumers_on_plane(other, 2, c, shape)
            if cells[x0:x1, y0:y1].any():
                raise ValueError(
                    f"boundary {j} rewrites cells inside the window "
                    f"{bc.window} of z-plane boundary {k} on z={c}; the "
                    "z-plane fixup would overwrite them")


def live_block_ids(mask: np.ndarray, block: int = BLOCK) -> np.ndarray:
    """int32 ids of the `block`-cell blocks of the flattened (x, y, z)
    lattice, z fastest, that hold at least one non-DEAD cell."""
    live = np.asarray(mask).reshape(-1) != CellType.DEAD
    pad = (-live.size) % block
    live = np.concatenate([live, np.zeros(pad, bool)])
    return np.nonzero(live.reshape(-1, block).any(axis=1))[0].astype(np.int32)


def live_tile_ids(mask: np.ndarray, tile=TILE) -> np.ndarray:
    """int32 ids of the (tile[0], tile[1], tile[2]) units of the (x, y,
    z) lattice (ceil-div, ids row-major over the unit grid with z
    fastest) whose cells inside the box include a non-DEAD one: the fused
    pair's live list (lbm_tpu's `live_tile_ids` over x segments of (y, z)
    column tiles)."""
    live = np.asarray(mask) != CellType.DEAD
    pads = [(0, (-n) % t) for n, t in zip(live.shape, tile)]
    live = np.pad(live, pads)
    (gx, gy, gz), (tx, ty, tz) = ((n // t for n, t in zip(live.shape, tile)),
                                  tile)
    tiles = live.reshape(gx, tx, gy, ty, gz, tz).any(axis=(1, 3, 5))
    return np.nonzero(tiles.reshape(-1))[0].astype(np.int32)


def fluid_cell_ids(mask: np.ndarray) -> np.ndarray:
    """int32 ids of the FLUID cells of the flattened (x, y, z) lattice, z
    fastest, ascending: the collide-stream kernel's launch list."""
    return np.flatnonzero(np.asarray(mask).reshape(-1) == CellType.FLUID
                          ).astype(np.int32)


def fluid_pair_ids(mask: np.ndarray) -> np.ndarray:
    """int32 ids of the aligned z pairs (x, y, 2j) and (x, y, 2j + 1) of
    the (x, y, z) lattice that hold a FLUID cell, ascending: the pairs the
    bf16 collide-stream kernel steps a thread a pair, the interior ones
    (CompiledCase.pair_launch). A pair's id is (x * Y + y) * ceil(Z / 2)
    + j; with an odd Z the last z cell is a pair of its own."""
    fluid = np.asarray(mask) == CellType.FLUID
    nx, ny, nz = fluid.shape
    fluid = np.pad(fluid.reshape(nx * ny, nz), ((0, 0), (0, nz % 2)))
    return np.flatnonzero(fluid.reshape(nx * ny, -1, 2).any(axis=2)
                          ).astype(np.int32)


def pair_interior_bits(mask: torch.Tensor, planes) -> torch.Tensor:
    """The bf16 kernel's interior pairs as int32 words on mask's device,
    one bit a z pair of the box (the pair of id k, fluid_pair_ids's
    numbering, at bit k % 32 of word k // 32): set when nz is even and
    neither cell of the pair asks anything but the plain pull and
    collision of the bulk: both cells FLUID, no source x - e_i of either
    (wrapped on x and y) a WALL or MOVING cell, no z source across the
    box's z ends (the pair is not the first or last of its row), and
    neither cell on a consumer plane of `planes`, the (axis, consumer
    coordinate) of each boundary. With an odd nz no pair is (its pairs'
    words would straddle the 4-byte alignment). mask: the (X, Y, Z) int8
    labels (on the card, 18 rolls of the full box take milliseconds)."""
    nx, ny, nz = mask.shape
    nzp = -(-nz // 2)
    inner = torch.zeros((nx, ny, nzp), dtype=torch.bool, device=mask.device)
    if nz % 2 == 0 and nz >= 4:
        stop = (mask == CellType.WALL) | (mask == CellType.MOVING)
        ok = mask == CellType.FLUID
        for i in range(1, D3Q19.Q):
            ok &= ~torch.roll(stop, tuple(int(v) for v in D3Q19.E[i]),
                              (0, 1, 2))
        inner = ok[..., 0::2] & ok[..., 1::2]
        inner[..., 0] = False
        inner[..., -1] = False
        for axis, coord in planes:
            if axis == 2:
                inner[..., coord // 2] = False
            else:
                inner.select(axis, coord).fill_(False)
    flat = inner.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-len(flat) % 32)])
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64,
                           device=mask.device)
    words = (flat.view(-1, 32).to(torch.int64) * weights).sum(1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class FluidLaunch:
    """The fp32 collide-stream kernel's launch over the fluid cells
    (collide_stream_list_kernel, fluid_launch_tables): a thread a lane of
    SEG-cell segments. segs (n, 2) int32: a segment's x | y << 16 and the
    z of its lane 0 (from 1 - SEG up); links (SEG n,) int32: each lane's
    word, LANE_IDLE or LANE_OUT, or a fluid cell's wall links (bit i:
    direction i's source is a wall, or with moving walls a wall or a
    moving wall); moving: with moving walls, each lane's moving-source
    bits (bit i: direction i's source is a moving wall), else None."""

    segs: torch.Tensor
    links: torch.Tensor
    moving: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.segs, self.links, self.moving) if t is not None)


def fluid_launch_tables(mask: torch.Tensor, moving: bool = False,
                        halo=None) -> FluidLaunch:
    """The FluidLaunch of a box's FLUID cells, on mask's device. Each run
    of fluid cells of an (x, y) row is covered by segments of SEG cells
    aligned to SEG in the flattened cell id (z fastest), so that a
    direction's loads and stores of a segment's lanes fill whole 32-byte
    sectors of fp32; segments ascend as the cells do, so a block holds
    neighbouring y rows of one x. A lane whose cell lies in the row but
    is not fluid is LANE_IDLE; one outside the row (its id in the row
    before or after) is LANE_OUT; a fluid cell's word holds its wall
    links, so the kernel loads no mask byte and computes no cell id
    from a division. moving: the instance's form with moving walls (a
    MOVING source is a link too, and `moving` marks it). halo: a shard's
    (axis, mask_lo, mask_hi), whose sources across its faces are the
    neighbours' rows (ShardCase). A box without a fluid cell launches one
    segment of LANE_OUT lanes."""
    nx, ny, nz = mask.shape
    if max(nx, ny) >= 1 << 16:
        raise ValueError(f"box {tuple(mask.shape)}: the fluid-cell launch "
                         "packs x and y in 16 bits each")
    dev = mask.device
    lane = torch.arange(SEG, device=dev)
    cells = torch.nonzero(mask.reshape(-1) == CellType.FLUID).reshape(-1)
    if not len(cells):
        out = torch.full((SEG,), LANE_OUT, dtype=torch.int32, device=dev)
        return FluidLaunch(
            segs=torch.zeros((1, 2), dtype=torch.int32, device=dev),
            links=out, moving=torch.zeros_like(out) if moving else None)
    row = cells // nz
    base = cells - cells % SEG
    new = torch.ones_like(cells, dtype=torch.bool)
    new[1:] = (row[1:] != row[:-1]) | (base[1:] != base[:-1])
    seg_of = torch.cumsum(new, 0) - 1
    srow, sbase = row[new], base[new]
    z0 = sbase - srow * nz
    segs = torch.stack([srow // ny | (srow % ny) << 16, z0], 1)
    lz = z0[:, None] + lane
    words = torch.where((lz < 0) | (lz >= nz), LANE_OUT, LANE_IDLE)
    x, y, z = cells // (ny * nz), row % ny, cells % nz
    ext, shard_axis = mask, None
    if halo is not None:
        shard_axis, lo, hi = halo
        ext = torch.cat([lo.unsqueeze(shard_axis), mask,
                         hi.unsqueeze(shard_axis)], shard_axis)
    stop = ext == CellType.WALL
    if moving:
        stop |= ext == CellType.MOVING
    links = torch.zeros_like(cells)
    mlinks = torch.zeros_like(cells)
    for i in range(1, D3Q19.Q):
        src = []
        for a, (c, n) in enumerate(zip((x, y, z), (nx, ny, nz))):
            s = c - int(D3Q19.E[i][a])
            src.append(s + 1 if a == shard_axis else s % n)
        links |= stop[src[0], src[1], src[2]].long() << i
        if moving:
            mlinks |= (ext[src[0], src[1], src[2]]
                       == CellType.MOVING).long() << i
    at = seg_of * SEG + (cells - base)
    words = words.reshape(-1)
    words[at] = links
    mwords = None
    if moving:
        mwords = torch.zeros_like(words)
        mwords[at] = mlinks
    return FluidLaunch(segs=segs.to(torch.int32),
                       links=words.to(torch.int32),
                       moving=None if mwords is None
                       else mwords.to(torch.int32))


def pair_bits_of(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Bool per pair id of `ids`: its bit in `bits`
    (pair_interior_bits)."""
    word = bits[(ids // 32).long()].to(torch.int64) & 0xFFFFFFFF
    return ((word >> (ids % 32).to(torch.int64)) & 1).bool()


def wk_footprint(bc: CompiledBC, shape) -> tuple[np.ndarray, np.ndarray]:
    """(ids, weights) of a windkessel outlet's flux footprint: the
    ascending int32 ids of the cells of its consumer plane where its
    flow_weight is nonzero, and their fp32 weights."""
    w = bc.flow_weight.cpu().numpy()
    a, b = np.nonzero(w)
    xyz = [None, None, None]
    xyz[bc.axis] = np.full(a.shape, bc.consumer_coord)
    lat = [x for x in range(3) if x != bc.axis]
    xyz[lat[0]], xyz[lat[1]] = a, b
    _, ny, nz = shape
    ids = (xyz[0] * ny + xyz[1]) * nz + xyz[2]
    return ids.astype(np.int32), w[a, b].astype(np.float32)


def fold_cell_ids(mask: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """The collide-stream launch list of a case with windkessel outlets:
    int32 ids of its FLUID cells, the fluid cells of `footprint` (the
    outlets' footprint ids, concatenated in boundary order) first and in
    its order, the others ascending after them. First, so the blocks
    whose threads also write flux terms (and read a z plane's cells at a
    stride) start in the launch's first wave: last, they ended it, and the
    [bgk+z] launch over such a list took 0.0711 ms against 0.0620 over the
    ascending one on the clinical coronary (H100, probes/fold_ab.py).
    ValueError when a cell lies in two footprints (a thread writes one
    term)."""
    if len(np.unique(footprint)) != len(footprint):
        raise ValueError("a cell lies in the flux footprints of two "
                         "windkessel outlets")
    fluid = np.asarray(mask).reshape(-1) == CellType.FLUID
    head = footprint[fluid[footprint]]
    rest = np.flatnonzero(fluid)
    rest = rest[~np.isin(rest, head)]
    ids = np.concatenate([head, rest]).astype(np.int32)
    return ids if len(ids) else np.zeros(1, np.int32)


def neighbor_wall(mask: np.ndarray, label: int = CellType.WALL) -> np.ndarray:
    """(19, X, Y, Z) bool: out[i][x] = mask[x - e_i] == label (WALL by
    default), wrapped."""
    wall = mask == label
    out = np.zeros((D3Q19.Q,) + mask.shape, dtype=bool)
    for i in range(1, D3Q19.Q):
        ex, ey, ez = (int(v) for v in D3Q19.E[i])
        out[i] = np.roll(wall, shift=(ex, ey, ez), axis=(0, 1, 2))
    return out


@dataclasses.dataclass(eq=False)
class ShardCase(CompiledCase):
    """One rank's window of a case split along `shard_axis`: shard_rows(n,
    world) rows of the axis (its n cells padded with DEAD rows at the end
    to a multiple of `world`). shape, mask,
    fluid, rho0, u0, live_blocks, fluid_cells and the boundaries' tables
    are the
    window's (lateral tables windowed along the shard axis, z windows in
    local coordinates); spec stays the whole case's. velsum_offset and
    usq_offset count this rank's own non-fluid cells only, never a pad
    row. mask_lo and mask_hi: the labels of the low neighbour's last row
    and the high neighbour's first row (the ring wraps), (A, B) int8 on
    the device."""

    shard_axis: int = 0
    rank: int = 0
    world: int = 1
    mask_lo: Optional[torch.Tensor] = None
    mask_hi: Optional[torch.Tensor] = None

    def halo(self, lo, hi) -> tuple:
        """The halo a shard's step takes with the planes lo and hi its
        neighbours sent: (shard_axis, lo, hi, mask_lo, mask_hi)."""
        return self.shard_axis, lo, hi, self.mask_lo, self.mask_hi

    @functools.cached_property
    def nbr_wall(self) -> torch.Tensor:
        """(19, X, Y, Z) bool of the window, built at first use by the
        dense halo step and K1d's plain version: the pull across the
        shard's faces tests the neighbours' rows mask_lo and mask_hi."""
        return self._halo_neighbors(CellType.WALL)

    @functools.cached_property
    def nbr_moving(self) -> Optional[torch.Tensor]:
        if self.wall_velocity is None:
            return None
        return self._halo_neighbors(CellType.MOVING)

    @functools.cached_property
    def fluid_launch(self) -> FluidLaunch:
        """The window's FluidLaunch, its links across the shard's faces
        from the neighbours' rows mask_lo and mask_hi (K1d's launch over
        the fluid cells)."""
        return fluid_launch_tables(
            self.mask, self.wall_velocity is not None,
            (self.shard_axis, self.mask_lo, self.mask_hi))

    def _halo_neighbors(self, label: int) -> torch.Tensor:
        """neighbor_wall of the window with the neighbours' rows beyond
        it on the shard axis (wrapped on the other axes)."""
        a, n = self.shard_axis, self.shape[self.shard_axis]
        ext = np.concatenate(
            [np.expand_dims(self.mask_lo.cpu().numpy(), a),
             self.mask.cpu().numpy(),
             np.expand_dims(self.mask_hi.cpu().numpy(), a)], axis=a)
        table = neighbor_wall(ext, label).take(range(1, n + 1), axis=1 + a)
        return torch.from_numpy(table).to(self.device)

    @functools.cached_property
    def bouzidi(self) -> Optional[tuple]:
        """The window's links: fluid cells whose source, across the shard's
        faces too (nbr_wall), is a wall, with the whole box's q (1/2 in
        the pad rows)."""
        spec = self.spec
        if spec.wall_sdf is None:
            return None
        rows = self.shape[self.shard_axis]
        q = take_rows(link_q(np.asarray(spec.mask), spec.wall_sdf,
                              table=self._link_table),
                       1 + self.shard_axis,
                       np.arange(self.rank * rows, (self.rank + 1) * rows),
                       spec.shape[self.shard_axis], 0.5)
        nbr = self.nbr_wall.cpu().numpy()
        fluid = self.fluid.cpu().numpy()
        table = [(np.zeros(0, np.int64), None)]
        for i in range(1, D3Q19.Q):
            ids = np.flatnonzero(nbr[i] & fluid)
            table.append((ids, q[i].ravel()[ids]))
        return flat_links(table, int(np.prod(self.shape)), self.device)

    @property
    def live_tiles(self):
        raise ValueError("fuse=2 requires a single-chip run with all NEE "
                         "boundaries on x/y planes")


def shard_rows(n: int, world: int) -> int:
    """Rows each of `world` shards holds of an axis of n cells: n padded
    with DEAD rows to a multiple of world (lbm_tpu pads to 16 world on the
    TPU; the port to world only)."""
    return -(-n // world)


def take_rows(arr, axis: int, idx: np.ndarray, n: int, fill):
    """Rows idx (padded-extent indices) of an array or tensor along
    `axis`, a copy of its kind; rows at or past n are padding, filled
    with `fill`."""
    if torch.is_tensor(arr):
        sel = torch.from_numpy(np.minimum(idx, n - 1)).to(arr.device)
        out = arr.index_select(axis, sel)
        pad = torch.from_numpy(idx >= n).to(arr.device)
        if bool(pad.any()):
            shape = [1] * out.dim()
            shape[axis] = len(idx)
            out = torch.where(pad.reshape(shape),
                              torch.full((), fill, dtype=out.dtype,
                                         device=out.device), out)
        return out.contiguous()
    out = np.take(np.asarray(arr), np.minimum(idx, n - 1), axis=axis)
    pad = idx >= n
    if pad.any():
        sl = [slice(None)] * out.ndim
        sl[axis] = pad
        out[tuple(sl)] = fill
    return np.ascontiguousarray(out)


def _window_bc(bc: CompiledBC, shard_axis: int, idx: np.ndarray, n: int,
               local_shape, device) -> CompiledBC:
    """A whole-box boundary's tables windowed to rows idx of the shard
    axis (one of its lateral axes): a windkessel outlet's flux footprint
    to the rank's part of it; a z boundary's window in local
    coordinates."""
    dim = _lat_axes(bc.axis).index(shard_axis)

    def win(t, lead):
        if t is None:
            return None
        a = take_rows(t.cpu().numpy(), lead + dim, idx, n, 0)
        return torch.from_numpy(a).to(device)

    valid = win(bc.valid, 1)
    weight = win(bc.flow_weight, 0)
    window = None
    if bc.axis == 2:
        window = valid_bbox(valid.cpu().numpy(), local_shape[:2],
                            footprint=(None if weight is None
                                       else weight.cpu().numpy()))
    return dataclasses.replace(
        bc, valid=valid, phi_star=win(bc.phi_star, 1),
        phi_star_series=win(bc.phi_star_series, 2), window=window,
        flow_weight=weight)


def compile_shard(spec: CaseSpec, rank: int, world: int, shard_axis: int,
                  device="cpu") -> ShardCase:
    """Rank `rank`'s window of `spec` split along lattice axis shard_axis
    into `world` shards of shard_rows(n, world) rows. The boundaries are
    compiled on the whole box and windowed, so every table is the one the
    whole-box compile gives. Raises ValueError for a boundary on the
    shard axis (lbm_tpu's words) and, when the extent needs padding, for
    a FLUID cell on the axis's first or last row: the pull wraps there,
    and the pad rows would cut it."""
    check_supported(spec)
    if shard_axis not in (0, 1, 2):
        raise ValueError(f"shard_axis must be 0, 1 or 2: {shard_axis!r}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    for bc in spec.boundaries:
        if bc.axis == shard_axis:
            raise ValueError(
                f"BC on axis {bc.axis} conflicts with shard axis {shard_axis}")
    device = canonical_device(device)
    mask = np.asarray(spec.mask)
    if mask.size and (mask.min() < -128 or mask.max() > 127):
        raise ValueError("mask labels must fit int8")
    shape = tuple(int(s) for s in spec.shape)
    n = shape[shard_axis]
    rows = shard_rows(n, world)
    n_pad = rows * world
    fluid_g = mask == CellType.FLUID
    if n_pad > n and (np.take(fluid_g, 0, axis=shard_axis).any()
                      or np.take(fluid_g, n - 1, axis=shard_axis).any()):
        raise ValueError(
            f"axis {shard_axis} ({n} cells) pads to {n_pad} for {world} "
            "shards, but FLUID cells lie on its first or last row, whose "
            "pull wraps around the box; pick a world size that divides "
            f"{n}")
    idx = np.arange(rank * rows, (rank + 1) * rows)
    ext = np.arange(rank * rows - 1, (rank + 1) * rows + 1) % n_pad
    local_shape = list(shape)
    local_shape[shard_axis] = rows
    local_shape = tuple(local_shape)
    a = shard_axis
    mask_loc = take_rows(mask, a, idx, n, CellType.DEAD).astype(np.int8)
    mask_ext = take_rows(mask, a, ext, n, CellType.DEAD).astype(np.int8)
    rho0 = take_rows(np.asarray(spec.rho0, np.float32), a, idx, n, 1.0)
    u0 = take_rows(np.asarray(spec.u0, np.float32), a + 1, idx, n, 0.0)
    fluid = mask_loc == CellType.FLUID
    own_rows = max(0, min(n - rank * rows, rows))
    own = np.zeros(local_shape, bool)
    sl = [slice(None)] * 3
    sl[a] = slice(0, own_rows)
    own[tuple(sl)] = True
    bcs = compile_bcs(spec, mask, "cpu")
    check_z_windows(bcs, shape)
    bcs = [_window_bc(bc, a, idx, n, local_shape, device) for bc in bcs]

    def ring(k):
        plane = np.take(mask_ext, k, axis=a)
        return torch.from_numpy(np.ascontiguousarray(plane)).to(device)

    return ShardCase(
        name=spec.name,
        shape=local_shape,
        tau=float(spec.tau),
        device=device,
        mask=torch.from_numpy(mask_loc).to(device),
        fluid=torch.from_numpy(fluid).to(device),
        bcs=bcs,
        rho0=torch.from_numpy(rho0).to(device),
        u0=torch.from_numpy(u0).to(device),
        **_residual_offsets(u0, own & ~fluid),
        spec=spec,
        **_live_lists(mask_loc, device),
        **_collision_fields(spec),
        shard_axis=a,
        rank=rank,
        world=world,
        mask_lo=ring(0),
        mask_hi=ring(rows + 1),
    )


def _residual_offsets(u0: np.ndarray, static: np.ndarray) -> dict:
    """velsum_offset and usq_offset: sum |u0| and |u0|^2 over the cells
    `static` selects (the non-fluid ones, which hold their initial state
    for good), in float64. |u0| is taken only where u0 is nonzero (the
    boundary planes), and the sums run over the same array of the static
    cells' speeds as a whole-box |u0| would give, bit for bit."""
    flat = u0.reshape(3, -1)
    moving = np.flatnonzero(np.any(flat != 0, axis=0))
    speed0 = np.zeros(flat.shape[1])
    speed0[moving] = np.sqrt(np.sum(
        flat[:, moving].astype(np.float64) ** 2, axis=0))
    sel = speed0[static.ravel()]
    return {"velsum_offset": float(np.sum(sel, dtype=np.float64)),
            "usq_offset": float(np.sum(sel ** 2, dtype=np.float64))}


def _live_lists(mask: np.ndarray, device) -> dict:
    """live_blocks and fluid_cells of a box: both None when skipping
    would not pay (SKIP_BELOW of the live blocks). A box without a live
    cell (a shard off the vessel tree) still launches once a step, over
    one all-DEAD block or one non-fluid cell, which the kernels skip
    (lbm_tpu's dead-tile filler), so its velsum slot is written."""
    ids = live_block_ids(mask)
    if len(ids) == 0:
        ids = np.zeros(1, np.int32)
    if len(ids) >= SKIP_BELOW * -(-mask.size // BLOCK):
        return {"live_blocks": None, "fluid_cells": None}
    cells = fluid_cell_ids(mask)
    if len(cells) == 0:
        cells = np.zeros(1, np.int32)
    return {"live_blocks": torch.from_numpy(ids).to(device),
            "fluid_cells": torch.from_numpy(cells).to(device)}


def _collision_fields(spec: CaseSpec) -> dict:
    """The collision branch's fields of a compiled case."""
    mrt_k, mrt_kf = mrt_of(spec)
    return {"tau_minus": tau_minus_of(spec), "mrt_k": mrt_k,
            "mrt_kf": mrt_kf,
            "closure": normalize_closure(spec.smagorinsky_cs, spec.rheology),
            "force": spec.force, "wall_velocity": spec.wall_velocity}


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
    shape = tuple(int(s) for s in spec.shape)
    bcs = compile_bcs(spec, mask, device)
    check_z_windows(bcs, shape)
    lists = _live_lists(mask, device)
    wk = [bc for bc in bcs if bc.windkessel is not None]
    if wk:
        footprint = np.concatenate([wk_footprint(bc, shape)[0] for bc in wk])
        lists["fluid_cells"] = torch.from_numpy(
            fold_cell_ids(mask, footprint)).to(device)
    return CompiledCase(
        name=spec.name,
        shape=shape,
        tau=float(spec.tau),
        device=device,
        mask=torch.from_numpy(mask.astype(np.int8)).to(device),
        fluid=torch.from_numpy(fluid).to(device),
        bcs=bcs,
        rho0=torch.from_numpy(np.ascontiguousarray(rho0)).to(device),
        u0=torch.from_numpy(np.ascontiguousarray(u0)).to(device),
        **_residual_offsets(u0, ~fluid),
        spec=spec,
        **lists,
        **_collision_fields(spec),
    )


__all__ = ["CompiledBC", "CompiledCase", "ShardCase", "compile_case",
           "compile_shard", "compile_bc", "compile_bcs", "shard_rows",
           "take_rows",
           "has_windkessel", "wk_init",
           "canonical_device", "check_supported", "check_z_windows",
           "CURVED_REFUSAL",
           "fluid_cell_ids", "fluid_pair_ids", "pair_interior_bits",
           "FluidLaunch", "fluid_launch_tables", "SEG", "LANE_IDLE",
           "LANE_OUT",
           "pair_bits_of", "fold_cell_ids",
           "fuse2_refusal",
           "kernel_refusal", "wk_footprint",
           "live_block_ids",
           "live_tile_ids", "mrt_of", "neighbor_wall", "tau_minus_of",
           "valid_bbox", "BLOCK", "MAX_BCS", "MAX_Z_BCS", "SKIP_BELOW",
           "TILE"]
