"""Passive scalar transport: advection-diffusion LBM (D3Q7) on a flow —
contrast washout, virtual bolus curves, residence time (torch port of
lbm_tpu/engine/scalar.py).

It solves dc/dt + u.grad(c) = D lap(c) + s with a second distribution g
over the D3Q7 subset of the D3Q19 order (rest + the six axis directions):

    g_i^eq = w_i c (1 + e_i.u / c_s2),   w = (1/4, 1/8 x 6), c_s2 = 1/4
    D = c_s2 (tau_g - 1/2)

One step (`transport_pass`), for cell x and direction i:

    v_i = g_i(x - e_i)                      pulled, wrapped on every axis
        = g_opp(i)(x)                       off a WALL or MOVING source
        = 2 w_i c_w(x - e_i) - g_opp(i)(x)  off a Dirichlet wall
        = c* phi_d + (g_d(x) - c_prev phi_d) (1 - 1/tau_g)
                        on a boundary's consumer plane, its one crossing
                        direction d; c_prev = sum_i g_i(x), c* prescribed
                        (a float, or a callable of the integer step,
                        evaluated on the host) or c_prev (zero gradient)
    c = sum_i v_i
    g_i'(x) = v_i - (v_i - c phi_i) * (1/tau_g) [+ c comp w_i] [+ s w_i]

at fluid cells; other cells keep their g (zeros from set-up on). phi_i =
w_i (1 + 4 e_i.u) with u projected (each component zeroed where a
neighbor along its axis blocks). The arithmetic is fp32 in the order the
CUDA kernel (kernels/csrc/scalar_stream.cu) repeats: sums in channel
order and 1/tau_g a multiplication by the fp32 reciprocal, the form of
lbm_tpu's Pallas kernel; lbm_tpu's dense pass divides by tau_g, which
differs in the last bit (the tests hold the two at atol 2e-6 on c of
order 1).

`ScalarTransport` advances g on a frozen velocity field (K7);
`CoupledTransport` advances the flow and g together, the scalar in each
step's live velocity (K8). With backend='kernel' (default) both step with
the CUDA kernels on a CUDA device and with their plain versions on the
CPU; backend='dense' is the dense PyTorch route. For the frozen class the
two compute the same pass. For the coupled class they differ as in
lbm_tpu: the dense route advects in the flow step's in-step Guo velocity
(m + F/2)/rho and can compensate the discrete divergence (div_fix); the
kernel route rebuilds (m' - F/2)/rho from the post-collision state, equal
in exact arithmetic, and has no div_fix. A traced tau_g (a tensor that
gradients flow through) is engine/adjoint.transport_rollout's, over the
dense pass of a ScalarTransport's statics.

mesh= (a parallel/mesh.LatticeMesh) splits the box along shard_axis
(default: the first axis without a boundary plane) over the group's
ranks, lbm_tpu's `mesh=` of these classes (every rank constructs the
transport and calls run, concentration, total, g, macro, save and
restore together; each returns the whole box on every rank, as
Simulation.f_standard() does):

  - ScalarTransport(backend='kernel'), lbm_tpu's ScalarTransportPallas
    (mesh=): each rank holds a block, its rows plus one neighbour row on
    each side (compile_scalar_shard(halo=True)). Per step it sends its
    edge rows' one crossing D3Q7 channel around the ring
    (parallel/halo.Exchange), writes what it receives into its halo rows
    and runs the unchanged K7 over its own rows' cell list. The frozen u
    and the div_fix field are the whole box's, cropped; the tables are
    the whole box's rows. Refused in lbm_tpu's words: a z shard and a
    boundary on the shard axis.
  - the dense routes of all three classes, lbm_tpu's GSPMD mesh=: each
    rank steps its window (engine/compile.compile_shard for the flow),
    the shard-axis pulls of transport_pass (and of defect, for div_fix)
    spliced from the received planes, as the flow's halo step does.
    A coupled step exchanges once for f and g together, once more for
    u's shard-axis component under div_fix, and, with windkessel
    outlets, adds the outlets' flux partials once (halo.make_halo_step's
    windkessel form).
  - the coupled kernel is single-chip: CoupledTransport and
    BuoyantTransport refuse mesh= with backend='kernel', in lbm_tpu's
    words.

Each boundary's footprint holds only the rank's own rows and counts the
whole footprint, so a rank's record is its share of each plane's mean;
the ranks' (steps, n_bc) float64 series (and BuoyantTransport's energy)
add in rank order once a run() call (LatticeMesh.sum_in_rank_order).
Where no cross-rank sum enters the state (g on every route, f without
windkessel outlets) the shards equal the whole box's run bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Union

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import D3Q19, momentum
from lbm_tpu_torch.engine.compile import (
    BLOCK,
    SKIP_BELOW,
    canonical_device,
    live_block_ids,
    shard_rows,
    take_rows,
)
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.engine.step import boussinesq_force, pull_one
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.parallel.halo import Exchange, edge_planes, edge_rows
from lbm_tpu_torch.parallel.mesh import free_axis

Q7 = 7
E7 = D3Q19.E[:Q7]                     # rest + 6 axis directions
OPP7 = [int(o) for o in D3Q19.OPP[:Q7]]   # closed under opposition
W7 = np.array([0.25] + [0.125] * 6, np.float32)
_F32 = np.float32


def tau_g_of(D_lat: float) -> float:
    """Relaxation time of lattice diffusivity D: tau_g = 1/2 + 4 D."""
    return 0.5 + 4.0 * float(D_lat)


def _tau_g(D, tau_g) -> float:
    if (D is None) == (tau_g is None):
        raise ValueError("give exactly one of D (lattice diffusivity) or "
                         "tau_g")
    tau_g = float(tau_g_of(D) if D is not None else tau_g)
    if not tau_g > 0.5:
        raise ValueError("tau_g must exceed 1/2 (D > 0)")
    return tau_g


def _axis_sign(i: int) -> tuple[int, int]:
    """(axis, sign) of the axis direction i in 1..6."""
    a = int(np.argmax(np.abs(E7[i])))
    return a, int(E7[i][a])


def crossing_channels(axis: int) -> tuple[int, int]:
    """(up, down): the D3Q7 channels that stream across a face normal to
    `axis`, e_axis = +1 and -1 (a shard sends up from its last row and
    down from its first)."""
    up = [i for i in range(1, Q7) if int(E7[i][axis]) == 1]
    down = [i for i in range(1, Q7) if int(E7[i][axis]) == -1]
    return up[0], down[0]


def pull_axis(x, e, halo=None):
    """pull_one of one axis direction e (the value at x - e arrives at x),
    on a shard its sources beyond the rows along the shard axis taken from
    halo = (axis, lo, hi): lo the low neighbour's last row, hi the high
    neighbour's first row, (A, B) each."""
    if halo is not None:
        axis, lo, hi = halo
        s = int(e[axis])
        n = x.shape[axis]
        if s > 0:
            return torch.cat([lo.unsqueeze(axis), x.narrow(axis, 0, n - 1)],
                             dim=axis)
        if s < 0:
            return torch.cat([x.narrow(axis, 1, n - 1), hi.unsqueeze(axis)],
                             dim=axis)
    return pull_one(x, e)


def phi7(u):
    """(7, ...) linear equilibrium factor w_i (1 + 4 e_i.u) of a (3, ...)
    velocity: g_eq = c[None] * phi7(u). Each moving direction reads one
    component: 1/8 (1 +- 4 u_a), the 1/8 scale exact."""
    out = [torch.full_like(u[0], float(W7[0]))]
    for i in range(1, Q7):
        a, s = _axis_sign(i)
        out.append(float(W7[i]) * (1.0 + (4.0 * s) * u[a]))
    return torch.stack(out)


def project(u, blocked_axes):
    """Impermeability projection: zero each velocity component at cells
    with a blocking neighbor along that axis."""
    return torch.where(blocked_axes, torch.zeros_like(u), u)


def blocking_tables(mask: np.ndarray):
    """(nbr_block (6, X, Y, Z), blocked_axes (3, X, Y, Z)) bool arrays:
    nbr_block[i-1][x] = the pull source x - e_i is a WALL or MOVING cell;
    blocked_axes[a] = either neighbor along axis a blocks."""
    mask = np.asarray(mask)
    blocking = (mask == CellType.WALL) | (mask == CellType.MOVING)
    nbr = [np.roll(blocking, shift=tuple(int(v) for v in E7[i]),
                   axis=(0, 1, 2)) for i in range(1, Q7)]
    return np.stack(nbr), np.stack([nbr[2 * a] | nbr[2 * a + 1]
                                    for a in range(3)])


@dataclasses.dataclass
class ScalarBC:
    """One boundary plane of the scalar: its crossing direction, the
    consumer plane (axis, coord), the (A, B) footprint on it and its size,
    and the prescribed concentration (None: zero gradient)."""

    dir: int
    axis: int
    sign: int
    coord: int
    valid: torch.Tensor
    count: int
    c_fn: Union[None, float, Callable] = None

    def c_star_at(self, t: int) -> Optional[float]:
        """The prescribed c* at integer step t, rounded to fp32; None for
        the zero-gradient plane."""
        if self.c_fn is None:
            return None
        v = self.c_fn(int(t)) if callable(self.c_fn) else self.c_fn
        return float(_F32(v))


def bc_geometry(spec: CaseSpec):
    """Per boundary (dir, axis, sign, consumer coord, footprint): in D3Q7
    exactly one direction crosses an axis plane; the footprint is the
    (A, B) bool array of the boundary's labelled cells."""
    mask = np.asarray(spec.mask)
    geo = []
    for bc in spec.boundaries:
        dirs = [i for i in range(1, Q7)
                if int(E7[i][bc.axis]) * bc.normal > 0]
        assert len(dirs) == 1
        plane = np.take(mask, bc.coord, axis=bc.axis) == bc.mask_value
        geo.append((dirs[0], bc.axis, int(E7[dirs[0]][bc.axis]),
                    bc.coord + bc.normal, plane))
    return geo


def dirichlet_walls(mask, wall_c):
    """Anti-bounce-back Dirichlet (fixed-value) scalar walls.

    wall_c: (X, Y, Z) float array, the prescribed value c_w at Dirichlet
    wall cells and NaN where the wall stays adiabatic (plain bounce-back).
    Every finite cell must be a static WALL cell (the closure omits a
    moving wall's velocity term). Returns (nbr_dir, cw2): the
    per-direction masks "the source x - e_i is a Dirichlet wall" and the
    constants 2 w_i c_w of that source, so the pass replaces the link's
    bounce-back with g_i(x, t+1) = 2 w_i c_w - g_opp(i)(x, t), which pins
    the half-way wall point to c_w."""
    wc = np.asarray(wall_c, np.float32)
    isd = np.isfinite(wc)
    if not (np.asarray(mask)[isd] == CellType.WALL).all():
        raise ValueError(
            "wall_c prescribes values at non-wall (or MOVING) cells; "
            "Dirichlet scalar values live on static WALL cells only (NaN = "
            "adiabatic)")
    vals = np.where(isd, wc, 0.0).astype(np.float32)
    nbr_dir, cw2 = [], []
    for i in range(1, Q7):
        sh = tuple(int(v) for v in E7[i])
        nbr_dir.append(np.roll(isd, shift=sh, axis=(0, 1, 2)))
        cw2.append((_F32(2.0) * W7[i]) * np.roll(vals, shift=sh,
                                                 axis=(0, 1, 2)))
    return np.stack(nbr_dir), np.stack(cw2).astype(np.float32)


def defect(u_proj, nbr_block, bcs, halo=None):
    """The scheme's exact one-pass concentration deviation at uniform c =
    1 (stream with bounce-back and the plane rewrites, then sum): the
    discrete divergence that div_fix cancels. bcs: the ScalarBC list;
    halo: a shard's (axis, lo, hi) rows of u_proj[axis] (pull_axis)."""
    d = torch.zeros_like(u_proj[0])
    terms = {}
    for i in range(1, Q7):
        a, s = _axis_sign(i)
        nb_u = pull_axis(u_proj[a], E7[i],
                         halo if halo is not None and halo[0] == a
                         else None) * float(s)
        terms[i] = torch.where(nbr_block[i - 1], torch.zeros_like(nb_u),
                               0.5 * nb_u)
        d = d + terms[i]
    for bc in bcs:
        # the rewrite takes the crossing pull in the consumer cell's own
        # u: swap that plane's term
        own = 0.5 * u_proj[bc.axis].select(bc.axis, bc.coord) * float(bc.sign)
        swap = own - terms[bc.dir].select(bc.axis, bc.coord)
        d.select(bc.axis, bc.coord).add_(
            torch.where(bc.valid, swap, torch.zeros_like(swap)))
    return d


def transport_pass(g, t: int, phi, nbr_block, bcs, omega, inv_tau,
                   div_comp, source: float, fluid,
                   dirichlet=None, halo=None):
    """One step of g at integer step t given the equilibrium factor phi:
    (g', c) with c the post-stream concentration of every cell. omega =
    1 - 1/tau_g and inv_tau = 1/tau_g are fp32 values, floats or, on
    engine/adjoint.transport_rollout's differentiable route, 0-dim fp32
    tensors (gradients flow through them); dirichlet is
    (nbr_dir, cw2) from dirichlet_walls or None; halo: a dense shard's
    (axis, lo, hi), lo the low neighbour's last row of the up crossing
    channel and hi the high neighbour's first row of the down one
    (crossing_channels), each (A, B)."""
    gs = g.unbind(0)        # under autograd one backward node for the reads
    pulled = [gs[0]]
    for i in range(1, Q7):
        own_opp = gs[OPP7[i]]
        v = torch.where(nbr_block[i - 1], own_opp,
                        pull_axis(gs[i], E7[i], halo))
        if dirichlet is not None:
            v = torch.where(dirichlet[0][i - 1], dirichlet[1][i - 1] - own_opp,
                            v)
        pulled.append(v)
    for bc in bcs:
        ph = phi[bc.dir].select(bc.axis, bc.coord)
        own = [gs[i].select(bc.axis, bc.coord) for i in range(Q7)]
        c_prev = own[0]
        for i in range(1, Q7):
            c_prev = c_prev + own[i]
        c_star = bc.c_star_at(t)
        if c_star is None:
            c_star = c_prev
        val = c_star * ph + (own[bc.dir] - c_prev * ph) * omega
        plane = pulled[bc.dir].select(bc.axis, bc.coord)
        plane.copy_(torch.where(bc.valid, val, plane))
    c = pulled[0]
    for i in range(1, Q7):
        c = c + pulled[i]
    c_comp = None if div_comp is None else c * div_comp
    post = []
    for i in range(Q7):
        p = pulled[i] - (pulled[i] - c * phi[i]) * inv_tau
        if c_comp is not None:
            p = p + c_comp * float(W7[i])
        if source:
            p = p + float(_F32(source) * W7[i])
        post.append(p)
    return torch.where(fluid[None], torch.stack(post), g), c


def live_velocity(f, g, fluid, blocked_axes, force=None):
    """The velocity the kernel route advects in, from the post-collision
    flow state f: u = (m' - F/2) * (1/rho), rho == 0 read as 1, projected.
    force: None or (buoyancy, c_ref, base), F = buoyancy (c - c_ref) +
    base with c the sum of the pre-update g."""
    rho, mom = momentum(f)
    if force is not None:
        F = boussinesq_force(g, fluid, *force)
        mom = tuple(m - 0.5 * F[a] for a, m in enumerate(mom))
    safe = torch.where(rho == 0, torch.ones_like(rho), rho)
    inv_rho = torch.ones_like(rho) / safe
    return project(torch.stack([m * inv_rho for m in mom]), blocked_axes)


def plane_means(c, bcs):
    """(n_bc,) float64: the mean of c over each boundary's footprint on
    its consumer plane (the washout record)."""
    out = [torch.where(bc.valid, c.select(bc.axis, bc.coord),
                       torch.zeros((), dtype=c.dtype, device=c.device)
                       ).sum(dtype=torch.float64) / bc.count for bc in bcs]
    return (torch.stack(out) if out else
            torch.zeros(0, dtype=torch.float64, device=c.device))


@dataclasses.dataclass(eq=False)  # hashed by identity: a weak-dict key
class ScalarCase:
    """The scalar's statics on one device, read by the plain pass and by
    the kernel wrapper (kernels/scalar_stream.py)."""

    spec: CaseSpec
    shape: tuple[int, int, int]
    device: torch.device
    tau_g: float
    inv_tau: float                   # fp32 1 / tau_g
    omega: float                     # fp32 1 - 1 / tau_g
    source: float
    mask: torch.Tensor               # (X, Y, Z) int8 labels
    fluid: torch.Tensor              # (X, Y, Z) bool
    bcs: list[ScalarBC]
    foot: torch.Tensor               # (n,) int32 footprints' lateral ids
    foot_off: np.ndarray             # (n_bc + 1,) int32 offsets into foot
    cells: Optional[torch.Tensor] = None   # (n,) int32 launch list
    u: Optional[torch.Tensor] = None       # frozen projected u (3, X, Y, Z)
    comp: Optional[torch.Tensor] = None    # div_fix field (X, Y, Z)
    wall_c: Optional[torch.Tensor] = None  # Dirichlet values, NaN elsewhere
    force: Optional[tuple] = None    # live u: (buoyancy, c_ref, base)

    @functools.cached_property
    def _tables(self):
        nbr, axes = blocking_tables(np.asarray(self.spec.mask))
        return (torch.from_numpy(nbr).to(self.device),
                torch.from_numpy(axes).to(self.device))

    @property
    def nbr_block(self) -> torch.Tensor:
        """(6, X, Y, Z) bool, built at first use (the plain pass and the
        set-up read it; the kernel tests the int8 mask)."""
        return self._tables[0]

    @property
    def blocked_axes(self) -> torch.Tensor:
        return self._tables[1]

    @functools.cached_property
    def dirichlet(self):
        """(nbr_dir, cw2) tensors of the Dirichlet walls, or None."""
        if self.wall_c is None:
            return None
        nbr_dir, cw2 = dirichlet_walls(np.asarray(self.spec.mask),
                                       self.wall_c.cpu().numpy())
        return (torch.from_numpy(nbr_dir).to(self.device),
                torch.from_numpy(cw2).to(self.device))

    @functools.cached_property
    def phi(self) -> torch.Tensor:
        """(7, X, Y, Z) equilibrium factor of the frozen velocity."""
        return phi7(self.u)

    def initial_g(self, c0, u_proj):
        """g(0) = c0 phi7(u_proj) at fluid cells, zeros elsewhere (zeros
        everywhere without c0)."""
        if c0 is None:
            return torch.zeros((Q7,) + self.shape, dtype=torch.float32,
                               device=self.device)
        c0 = torch.as_tensor(np.asarray(c0, np.float32)).to(self.device)
        if tuple(c0.shape) != self.shape:
            raise ValueError(f"c0 shape {tuple(c0.shape)} != {self.shape}")
        return torch.where(self.fluid[None], c0[None] * phi7(u_proj),
                           torch.zeros((), device=self.device)).contiguous()


def footprint_lists(planes) -> tuple[np.ndarray, np.ndarray]:
    """(foot, offsets) of the boundaries' (A, B) footprints: foot the
    ascending flat lateral indices (a * B + b) of each footprint's cells,
    boundary after boundary, int32; boundary k's at foot[offsets[k] :
    offsets[k + 1]]. The record sums the plane buffers over these."""
    lists = [np.flatnonzero(np.asarray(p).reshape(-1)).astype(np.int32)
             for p in planes]
    offsets = np.zeros(len(lists) + 1, np.int32)
    offsets[1:] = np.cumsum([len(a) for a in lists])
    foot = np.concatenate(lists) if lists else np.zeros(0, np.int32)
    return foot.astype(np.int32), offsets


def scalar_touched(mask: np.ndarray, geo) -> np.ndarray:
    """(X, Y, Z) bool: the cells one scalar step touches, the FLUID cells
    and every cell under a boundary's footprint on its consumer plane
    (whose post-stream c the record reads, fluid or not). geo:
    bc_geometry's rows."""
    touched = np.asarray(mask) == CellType.FLUID
    for _, axis, _, coord, plane in geo:
        sl = [slice(None)] * 3
        sl[axis] = coord
        touched[tuple(sl)] |= plane
    return touched


def scalar_cell_ids(mask: np.ndarray, geo) -> np.ndarray:
    """int32 ids, ascending, of scalar_touched's cells: the scalar
    kernel's launch list, a thread a cell (z fastest, as the flow
    kernel's fluid list)."""
    return np.flatnonzero(scalar_touched(mask, geo).reshape(-1)
                          ).astype(np.int32)


def compile_scalar(spec: CaseSpec, device, D=None, tau_g=None, inlet_c=None,
                   source: float = 0.0, wall_c=None, mask=None,
                   fluid=None) -> ScalarCase:
    """The ScalarCase of a flow case: relaxation constants, boundary
    planes with their prescribed concentrations (inlet_c: {boundary
    index: float or callable(step)}, the others zero gradient), their
    footprint lists, Dirichlet wall values and the launch list
    (scalar_cell_ids, under the flow's SKIP_BELOW rule of the live
    blocks; None, every cell, where it would not pay). mask, fluid: a
    CompiledCase's tensors to share, else built here."""
    device = canonical_device(device)
    tau_g = _tau_g(D, tau_g)
    mask_np = np.asarray(spec.mask)
    geo = bc_geometry(spec)
    bcs = _scalar_bcs(spec, geo, inlet_c, [p for *_, p in geo], device)
    if mask is None:
        mask = torch.from_numpy(mask_np.astype(np.int8)).to(device)
        fluid = torch.from_numpy(mask_np == CellType.FLUID).to(device)
    cells = None
    if len(live_block_ids(mask_np)) < SKIP_BELOW * -(-mask_np.size // BLOCK):
        ids = scalar_cell_ids(mask_np, geo)
        cells = torch.from_numpy(ids if len(ids) else np.zeros(1, np.int32)
                                 ).to(device)
    foot, foot_off = footprint_lists([p for *_, p in geo])
    wc = None
    if wall_c is not None:
        wc_np = np.ascontiguousarray(wall_c, dtype=np.float32)
        if wc_np.shape != tuple(spec.shape):
            raise ValueError(f"wall_c shape {wc_np.shape} != {spec.shape}")
        dirichlet_walls(mask_np, wc_np)     # refuses non-wall cells
        wc = torch.from_numpy(wc_np).to(device)
    return ScalarCase(
        spec=spec, shape=tuple(int(s) for s in spec.shape), device=device,
        tau_g=tau_g, inv_tau=float(_F32(1.0 / tau_g)),
        omega=float(_F32(1.0 - 1.0 / tau_g)), source=float(source),
        mask=mask, fluid=fluid, bcs=bcs, foot=torch.from_numpy(foot).to(device),
        foot_off=foot_off, cells=cells, wall_c=wc)


def _scalar_bcs(spec: CaseSpec, geo, inlet_c, planes, device) -> list:
    """The ScalarBCs of bc_geometry's rows `geo` with footprints `planes`
    (the whole box's, or a shard's rows of them) and each whole
    footprint's size; inlet_c as in compile_scalar."""
    inlet_c = dict(inlet_c or {})
    bcs = []
    for k, ((d, axis, sign, coord, whole), plane) in enumerate(
            zip(geo, planes)):
        if not 0 <= coord < spec.shape[axis]:
            raise ValueError(f"boundary {k}: consumer plane {coord} outside "
                             f"axis {axis}")
        bcs.append(ScalarBC(
            dir=d, axis=axis, sign=sign, coord=coord,
            valid=torch.from_numpy(np.ascontiguousarray(plane)).to(device),
            count=max(int(whole.sum()), 1), c_fn=inlet_c.pop(k, None)))
    if inlet_c:
        raise ValueError(f"inlet_c names absent boundaries: {inlet_c}")
    return bcs


@dataclasses.dataclass(eq=False)
class ScalarShard(ScalarCase):
    """One rank's part of a scalar case split along `shard_axis` into
    `world` shards of `rows` = shard_rows(n, world) rows (n padded with
    DEAD rows at the end): its window, or with `halo` its block, the
    window plus one neighbour row on each side (the ring wraps), where
    the sharded kernel route writes what it receives. spec stays the
    whole case's; `idx` holds the padded-extent rows of the local ones.
    mask and wall_c are the local rows'; the tables (nbr_block,
    blocked_axes, dirichlet) are the whole box's rows; fluid, the
    boundaries' footprints, their lists and the launch list hold the
    rank's own rows only, and each boundary counts its whole footprint,
    so the record is the rank's share of each plane's mean."""

    shard_axis: int = 0
    rank: int = 0
    world: int = 1
    halo: bool = False
    rows: int = 0
    idx: Optional[np.ndarray] = None
    whole_wall_c: Optional[np.ndarray] = None

    def take(self, arr, lead: int, fill=0):
        """The local rows of a whole-box array or tensor with `lead`
        leading dims (rows past the box: `fill`)."""
        return take_rows(arr, lead + self.shard_axis, self.idx,
                          self.spec.shape[self.shard_axis], fill)

    def own(self, t, lead: int):
        """The rank's own rows of a local tensor (a block's without its
        halo rows)."""
        if not self.halo:
            return t
        return t.narrow(lead + self.shard_axis, 1, self.rows)

    def _ring(self, arr, fill):
        """The local rows of a whole-box (X, Y, Z) array with one more
        row on each side, as the whole box's neighbours of the local
        rows (the edge rows of a padded box meet pad rows, which
        compile_scalar_shard refuses to matter)."""
        n_pad = self.rows * self.world
        ext = np.concatenate([[self.idx[0] - 1], self.idx,
                              [self.idx[-1] + 1]]) % n_pad
        return take_rows(arr, self.shard_axis, ext,
                          self.spec.shape[self.shard_axis], fill)

    def _crop(self, table: np.ndarray) -> torch.Tensor:
        """A (k, ...) table of _ring's rows cut to the local ones."""
        inner = np.take(table, range(1, len(self.idx) + 1),
                        axis=1 + self.shard_axis)
        return torch.from_numpy(np.ascontiguousarray(inner)).to(self.device)

    @functools.cached_property
    def _tables(self):
        nbr, axes = blocking_tables(self._ring(np.asarray(self.spec.mask),
                                               CellType.DEAD))
        return self._crop(nbr), self._crop(axes)

    @functools.cached_property
    def dirichlet(self):
        if self.whole_wall_c is None:
            return None
        nbr_dir, cw2 = dirichlet_walls(
            self._ring(np.asarray(self.spec.mask), CellType.DEAD),
            self._ring(self.whole_wall_c, np.nan))
        return self._crop(nbr_dir), self._crop(cw2)


def compile_scalar_shard(spec: CaseSpec, rank: int, world: int,
                         shard_axis: int, device, D=None, tau_g=None,
                         inlet_c=None, source: float = 0.0, wall_c=None,
                         halo: bool = False) -> ScalarShard:
    """Rank `rank`'s ScalarShard of `spec` split along shard_axis into
    `world` shards: its window, or with halo=True its block. Raises
    ValueError for a boundary on the shard axis (lbm_tpu's words) and,
    when the extent needs padding, for a cell the step touches on the
    axis's first or last row (the pulls wrap there, and the pad rows
    would cut them)."""
    device = canonical_device(device)
    tau_g = _tau_g(D, tau_g)
    for bc in spec.boundaries:
        if bc.axis == shard_axis:
            raise ValueError("BC on the shard axis")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    a = shard_axis
    mask = np.asarray(spec.mask)
    n = int(spec.shape[a])
    rows = shard_rows(n, world)
    n_pad = rows * world
    geo = bc_geometry(spec)
    touched = scalar_touched(mask, geo)
    if n_pad > n and (np.take(touched, 0, axis=a).any()
                      or np.take(touched, n - 1, axis=a).any()):
        raise ValueError(
            f"axis {a} ({n} cells) pads to {n_pad} for {world} shards, but "
            "cells the scalar step touches lie on its first or last row, "
            "whose pull wraps around the box; pick a world size that "
            f"divides {n}")
    if halo:
        idx = np.arange(rank * rows - 1, (rank + 1) * rows + 1) % n_pad
        own = np.zeros(rows + 2, bool)
        own[1:-1] = True
    else:
        idx = np.arange(rank * rows, (rank + 1) * rows)
        own = np.ones(rows, bool)
    own &= idx < n
    shape = list(int(v) for v in spec.shape)
    shape[a] = len(idx)
    own3 = own.reshape([-1 if d == a else 1 for d in range(3)])
    mask_loc = take_rows(mask, a, idx, n, CellType.DEAD).astype(np.int8)
    planes = []
    for d, axis, _, _, plane in geo:
        dim = [x for x in range(3) if x != axis].index(a)
        planes.append(take_rows(plane, dim, idx, n, False)
                      & own.reshape([-1 if x == dim else 1
                                     for x in range(2)]))
    bcs = _scalar_bcs(spec, geo, inlet_c, planes, device)
    ids = np.flatnonzero((take_rows(touched, a, idx, n, False) & own3)
                         .reshape(-1)).astype(np.int32)
    foot, foot_off = footprint_lists(planes)
    wc = wc_whole = None
    if wall_c is not None:
        wc_whole = np.ascontiguousarray(wall_c, dtype=np.float32)
        if wc_whole.shape != tuple(spec.shape):
            raise ValueError(f"wall_c shape {wc_whole.shape} != {spec.shape}")
        dirichlet_walls(mask, wc_whole)     # refuses non-wall cells
        wc = torch.from_numpy(take_rows(wc_whole, a, idx, n, np.nan)
                              ).to(device)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return ScalarShard(
        spec=spec, shape=tuple(shape), device=device, tau_g=tau_g,
        inv_tau=float(_F32(1.0 / tau_g)),
        omega=float(_F32(1.0 - 1.0 / tau_g)), source=float(source),
        mask=dev(mask_loc), fluid=dev((mask_loc == CellType.FLUID) & own3),
        bcs=bcs,
        # the lists the kernel reads are never empty: a rank off the
        # vessel tree launches over one id past its box, which the
        # kernel's thread skips (its record row is still written)
        foot=dev(foot if len(foot) else np.zeros(1, np.int32)),
        foot_off=foot_off,
        cells=dev(ids if len(ids) else np.array([np.prod(shape)], np.int32)),
        wall_c=wc, shard_axis=a, rank=rank, world=world, halo=halo,
        rows=rows, idx=idx, whole_wall_c=wc_whole)


def _as_float_tensor(a) -> torch.Tensor:
    """A float32 tensor of an array or tensor (arrays are copied: they
    may be read-only views of another framework's buffers)."""
    if torch.is_tensor(a):
        return a.to(torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _check_backend(backend: str) -> None:
    if backend not in ("kernel", "dense"):
        raise ValueError(f"backend must be 'kernel' or 'dense': {backend!r}")


class _ScalarState:
    """The g state of a transport and what every route reads from it:
    the local state `_g` (a shard's window or block under a mesh), and
    the whole box's views of it (g, concentration, total), gathered on
    every rank under a mesh."""

    sc: ScalarCase
    spec: CaseSpec
    mesh = None
    shard_axis: Optional[int] = None

    @property
    def g(self) -> torch.Tensor:
        """The (7, X, Y, Z) state: under a mesh the whole box's, gathered
        on every rank (every rank reads it together)."""
        if self.mesh is None:
            return self._g
        return self._whole(self.sc.own(self._g, 1), 1)

    @g.setter
    def g(self, value) -> None:
        self._g = value

    @property
    def fluid(self) -> torch.Tensor:
        """(X, Y, Z) bool fluid cells of the whole box."""
        if self.mesh is None:
            return self.sc.fluid
        return torch.from_numpy(np.asarray(self.spec.mask) == CellType.FLUID
                                ).to(self.sc.device)

    def _place(self, device, mesh, shard_axis) -> torch.device:
        """The device the state lives on; under a mesh the mesh's, after
        setting the shard axis (default: the first axis without a
        boundary plane)."""
        from lbm_tpu_torch.engine.runner import resolve_device

        self.mesh = mesh
        self.shard_axis = None
        if mesh is None:
            if shard_axis is not None:
                raise ValueError("shard_axis= needs mesh=")
            return resolve_device(device)
        if resolve_device(device).type != mesh.device.type:
            raise ValueError(f"device={device!r}, but the mesh's ranks run "
                             f"on {mesh.device.type}")
        self.shard_axis = (free_axis(self.spec) if shard_axis is None
                           else int(shard_axis))
        self._swap = Exchange(mesh)
        return mesh.device

    def _whole(self, t, lead: int) -> torch.Tensor:
        """A field of the rank's own rows (`lead` leading dims) as the
        whole box's, on every rank (the pad rows cut)."""
        dim = lead + self.shard_axis
        whole = self.mesh.all_gather(t.contiguous(), dim=dim)
        return whole.narrow(dim, 0, self.spec.shape[self.shard_axis]) \
            .contiguous()

    def _local(self, t, lead: int):
        """The local rows of a whole-box array or tensor (itself without a
        mesh)."""
        return t if self.mesh is None else self.sc.take(t, lead)

    def set_g(self, g) -> None:
        """Load a (7, X, Y, Z) state of the whole box (array or tensor)
        into both buffers; the transport keeps its own copies (under a
        mesh, its rows)."""
        g = _as_float_tensor(g)
        if tuple(g.shape) != (Q7,) + tuple(self.spec.shape):
            raise ValueError(f"g shape {tuple(g.shape)} != "
                             f"(7, *{tuple(self.spec.shape)})")
        self._g = self._local(g, 1).to(self.sc.device, copy=True) \
            .contiguous()
        self._g_spare = self._g.clone()

    def concentration(self) -> torch.Tensor:
        """(X, Y, Z) scalar field (zeros at non-fluid cells)."""
        c = self._g[0]
        for i in range(1, Q7):
            c = c + self._g[i]
        c = torch.where(self.sc.fluid, c, torch.zeros_like(c))
        if self.mesh is None:
            return c
        return self._whole(self.sc.own(c, 0), 0)

    def total(self) -> float:
        """Total scalar content (the conservation audit), summed in
        float64 on the device."""
        return float(self.g.sum(dtype=torch.float64))

    def _g_halo(self) -> tuple:
        """A dense shard's halo for transport_pass: the crossing channels'
        rows its neighbours send (one exchange)."""
        a = self.shard_axis
        up, down = crossing_channels(a)
        lo, hi = self._swap(*edge_rows(self._g, a, [up], [down]))
        return a, lo[0], hi[0]

    def _series(self, n_steps: int, record):
        if record is None:
            return None
        bad = [k for k in record if not 0 <= k < len(self.sc.bcs)]
        if bad:
            raise ValueError(f"record names absent boundaries: {bad}")
        return torch.zeros((n_steps, len(self.sc.bcs)), dtype=torch.float64,
                           device=self.sc.device)

    def _columns(self, series, record):
        """The recorded columns on the host; under a mesh the ranks'
        shares added in rank order (one gather a run() call)."""
        if record is None:
            return None
        out = series[:, list(record)].cpu().numpy()
        if self.mesh is not None:
            out = self.mesh.sum_in_rank_order(out)
        return out


class ScalarTransport(_ScalarState):
    """Frozen-field advection-diffusion on one case's geometry (the
    counterpart of lbm_tpu's ScalarTransport, and with backend='kernel'
    of its ScalarTransportPallas).

    spec: the flow CaseSpec (mask and boundary planes are reused).
    u: (3, X, Y, Z) frozen lattice velocity (a converged macro()[1]).
    D / tau_g: lattice diffusivity (one of the two).
    inlet_c: {boundary index: c}, c a float or a callable of the integer
       step (a bolus gate: lambda t: 1.0 if t < 500 else 0.0); planes not
       listed get the zero-gradient outflow rewrite.
    source: uniform volumetric source s on fluid cells (mean age: source
       = 1, inlet c = 0).
    c0: initial concentration field (default 0).
    div_fix: compensate the frozen field's discrete divergence with
       + c(x) * -defect(x) (see `defect`), so uniform c is a fixed point.
    wall_c: (X, Y, Z) Dirichlet wall values, NaN = adiabatic; the
       divergence compensation assumes bounce-back walls and is
       approximate next to Dirichlet cells.
    device, backend: 'kernel' steps with lbm_scalar_stream on a CUDA
       device (its plain version on the CPU), 'dense' with the plain pass.
    mesh, shard_axis: a sharded run (module docstring); u, c0 and wall_c
       are the whole box's on every rank. The kernel route shards x or y
       only, as lbm_tpu's.
    """

    def __init__(self, spec: CaseSpec, u, D: Optional[float] = None,
                 tau_g: Optional[float] = None,
                 inlet_c: Optional[dict] = None, source: float = 0.0,
                 c0=None, div_fix: bool = True, wall_c=None, device="cuda",
                 backend: str = "kernel", mesh=None,
                 shard_axis: Optional[int] = None):
        _check_backend(backend)
        self.backend = backend
        self.spec = spec
        device = self._place(device, mesh, shard_axis)
        if mesh is not None and backend == "kernel":
            if self.shard_axis not in (0, 1):
                raise ValueError(
                    "the packed scalar layout keeps z on the lane dim; shard "
                    "x or y (use the dense GSPMD route for z-only cases)")
            if any(bc.axis == self.shard_axis for bc in spec.boundaries):
                raise ValueError("BC on the shard axis")
        sc = compile_scalar(spec, device, D, tau_g, inlet_c, source, wall_c)
        u = _as_float_tensor(u)
        if tuple(u.shape) != (3,) + sc.shape:
            raise ValueError(f"u shape {tuple(u.shape)} != (3, *{sc.shape})")
        u_proj = project(u.to(sc.device), sc.blocked_axes).contiguous()
        comp = None
        if div_fix:
            d = defect(u_proj, sc.nbr_block, sc.bcs)
            comp = torch.where(sc.fluid, -d, torch.zeros_like(d))
            if wall_c is not None:
                print("[lbm_tpu_torch] ScalarTransport: div_fix=True with "
                      "wall_c: the divergence compensation assumes "
                      "bounce-back walls and is approximate near Dirichlet "
                      "cells; pass div_fix=False to silence", flush=True)
        if mesh is not None:
            # the whole box's frozen fields, cropped to the rank's rows
            del sc
            sc = compile_scalar_shard(
                spec, mesh.rank, mesh.world, self.shard_axis, device, D,
                tau_g, inlet_c, source, wall_c, halo=backend == "kernel")
            u_proj = sc.take(u_proj, 1)
            comp = None if comp is None else sc.take(comp, 0)
        sc.u, sc.comp = u_proj, comp
        self.sc = sc
        self.tau_g = sc.tau_g
        if c0 is not None:
            c0 = self._local(np.asarray(c0, np.float32), 0)
        self._g = sc.initial_g(c0, sc.u)
        self._g_spare = self._g.clone()
        self.t = 0

    def _fill_halo_rows(self) -> None:
        """The sharded kernel route's exchange: the crossing channel of
        the block's edge rows around the ring, written into its halo rows
        (on the current stream, before the launch that reads them)."""
        a, n = self.shard_axis, self.sc.rows
        up, down = crossing_channels(a)
        g = self._g
        lo, hi = self._swap(*edge_rows(g, a, [up], [down], first=1, last=n))
        g.select(1 + a, 0)[up].copy_(lo[0])
        g.select(1 + a, n + 1)[down].copy_(hi[0])

    def run(self, n_steps: int, record: Optional[list] = None):
        """Advance n_steps. record: boundary indices whose consumer-plane
        mean concentration is sampled every step; returns the (n_steps,
        len(record)) float64 series (the washout curves), read from the
        device once at the end (under a mesh the ranks' shares added in
        rank order), else None."""
        from lbm_tpu_torch.kernels import scalar_stream as S

        sc = self.sc
        series = self._series(n_steps, record)
        for k in range(n_steps):
            t = self.t + k
            if self.backend == "kernel":
                if self.mesh is not None:
                    self._fill_halo_rows()
                S.scalar_stream(self._g, self._g_spare, sc, t,
                                series=series, slot=k)
                self._g, self._g_spare = self._g_spare, self._g
                continue
            self._g, c = transport_pass(
                self._g, t, sc.phi, sc.nbr_block, sc.bcs, sc.omega,
                sc.inv_tau, sc.comp, sc.source, sc.fluid, sc.dirichlet,
                halo=None if self.mesh is None else self._g_halo())
            if series is not None:
                series[k] = plane_means(c, sc.bcs)
        self.t += n_steps
        return self._columns(series, record)


class CoupledTransport(_ScalarState):
    """Time-resolved transport: the flow and the scalar advance together,
    the scalar in each step's live velocity — the pulsatile regime where
    a frozen field is wrong (the counterpart of lbm_tpu's
    CoupledTransport, and with backend='kernel' of its
    CoupledTransportPallas). Per step the flow step runs first (with its
    z planes), then the scalar step reads the new flow state and
    the pre-step g.

    div_fix: dense route only (default on there); the kernel route has no
    divergence compensation, as lbm_tpu's. f0, wk0: optional initial flow
    state and windkessel P_c (e.g. a Simulation's f_standard() and wk).
    With windkessel outlets the carried P_c (`wk`, on the device) steps
    with the flow: on the kernel route each step is the collide-stream
    launch with the outlets' flux folded in and its reduction (the flux
    kernel primes the fold once a run() call), then the scalar kernel and
    its record; the dense route steps pulled_state_wk. A force field does
    not compose with windkessel outlets (lbm_tpu's runtime-force step
    refuses them). mesh, shard_axis: the dense route only (module
    docstring); f0, c0 and wall_c are the whole box's on every rank, and
    f is the whole box's, gathered, as g is.
    """

    def __init__(self, spec: CaseSpec, D: Optional[float] = None,
                 tau_g: Optional[float] = None,
                 inlet_c: Optional[dict] = None, source: float = 0.0,
                 c0=None, div_fix: Optional[bool] = None, wall_c=None,
                 f0=None, device="cuda", backend: str = "kernel",
                 field=None, wk0=None, mesh=None,
                 shard_axis: Optional[int] = None):
        from lbm_tpu_torch.engine.compile import (
            compile_case,
            compile_shard,
            wk_init,
        )
        from lbm_tpu_torch.engine.step import initial_f
        from lbm_tpu_torch.kernels import collide_stream as K

        _check_backend(backend)
        if backend == "kernel" and div_fix:
            raise ValueError("the kernel route has no div_fix (the defect "
                             "belongs to one frozen field); pass "
                             "backend='dense'")
        if backend == "kernel" and mesh is not None:
            raise ValueError(
                "mesh= is the frozen-field kernel route; the coupled kernel "
                "is single-chip (use the dense CoupledTransport mesh= for "
                "sharded time-resolved transport)")
        self.backend = backend
        self.div_fix = backend == "dense" and div_fix is not False
        self.spec = spec
        self.field = field              # kernels.collide_stream.ForceField
        device = self._place(device, mesh, shard_axis)
        if mesh is None:
            self.cc = compile_case(spec, device)
        else:
            self.cc = compile_shard(spec, mesh.rank, mesh.world,
                                    self.shard_axis, device)
        if backend == "kernel":
            K.collision_descriptor(self.cc, field)  # refuses what it lacks
        cc = self.cc
        w0 = wk_init(cc.bcs)
        if w0 is not None and field is not None:
            raise ValueError("windkessel outlets are not wired for the "
                             "runtime-force step")
        self.wk = None
        if w0 is not None:
            self.wk = torch.as_tensor(
                np.asarray(w0 if wk0 is None else wk0, np.float32)
            ).to(cc.device).contiguous()
        elif wk0 is not None:
            raise ValueError("wk0 was given for a case without windkessel "
                             "outlets")
        if mesh is None:
            self.sc = compile_scalar(spec, cc.device, D, tau_g, inlet_c,
                                     source, wall_c, mask=cc.mask,
                                     fluid=cc.fluid)
        else:
            self.sc = compile_scalar_shard(spec, mesh.rank, mesh.world,
                                           self.shard_axis, cc.device, D,
                                           tau_g, inlet_c, source, wall_c)
        base = (0.0, 0.0, 0.0) if cc.force is None else cc.force
        if field is not None:
            self.sc.force = (field.buoyancy, field.c_ref, base)
        elif cc.force is not None:
            self.sc.force = ((0.0, 0.0, 0.0), 0.0, base)
        self.tau_g = self.sc.tau_g
        if f0 is None:
            self._load_f(initial_f(cc))
        else:
            self.set_f(f0)
        if c0 is not None:
            c0 = self._local(np.asarray(c0, np.float32), 0)
        self._g = self.sc.initial_g(
            c0, None if c0 is None else project(cc.u0, self.sc.blocked_axes))
        self._g_spare = self._g.clone()
        self.t = 0

    @property
    def f(self) -> torch.Tensor:
        """The (19, X, Y, Z) flow state: under a mesh the whole box's,
        gathered on every rank."""
        if self.mesh is None:
            return self._f
        return self._whole(self._f, 1)

    @f.setter
    def f(self, value) -> None:
        self._f = value

    def set_f(self, f) -> None:
        """Load a (19, X, Y, Z) flow state of the whole box into both
        buffers (the flow kernel never writes a non-fluid cell, so they
        must agree there); under a mesh the rank keeps its window."""
        f = _as_float_tensor(f)
        if tuple(f.shape) != (19,) + tuple(self.spec.shape):
            raise ValueError(f"f shape {tuple(f.shape)} != "
                             f"(19, *{tuple(self.spec.shape)})")
        if self.mesh is not None:
            from lbm_tpu_torch.bridge import shard_window

            f = shard_window(f, self.mesh.rank, self.mesh.world,
                             self.shard_axis)
        self._load_f(f)

    def _load_f(self, f) -> None:
        self._f = f.to(self.cc.device, copy=True).contiguous()
        self._f_spare = self._f.clone() if self.backend == "kernel" else None

    def _force_field(self):
        """The (3, X, Y, Z) force the dense flow step takes this step
        (None without a force field: the step uses cc.force)."""
        if self.field is None:
            return None
        return boussinesq_force(self._g, self.sc.fluid, self.field.buoyancy,
                                self.field.c_ref, self.cc.force)

    def _exchange(self):
        """(flow halo, scalar halo) of a dense shard's step: f's five
        crossing populations and g's crossing channel of its edge rows,
        in one exchange; (None, None) without a mesh."""
        if self.mesh is None:
            return None, None
        a = self.shard_axis
        up, down = crossing_channels(a)
        f_lo, f_hi = edge_planes(self._f, a)
        g_lo, g_hi = edge_rows(self._g, a, [up], [down])
        lo, hi = self._swap(torch.cat([f_lo, g_lo]), torch.cat([f_hi, g_hi]))
        return self.cc.halo(lo[:-1], hi[:-1]), (a, lo[-1], hi[-1])

    def _u_halo(self, u_proj):
        """A dense shard's rows of u_proj[shard_axis] across its faces
        (defect's pulls), one exchange; None without a mesh."""
        if self.mesh is None:
            return None
        a = self.shard_axis
        lo, hi = self._swap(*edge_rows(u_proj, a, [a], [a]))
        return a, lo[0], hi[0]

    def _dense_step(self, t: int):
        """(c, u): one dense coupled step; the scalar advects in the flow
        step's in-step velocity."""
        from lbm_tpu_torch.engine.step import (
            pulled_state,
            pulled_state_wk,
            step_tail,
        )

        sc, cc = self.sc, self.cc
        halo, g_halo = self._exchange()
        if self.wk is not None:
            pulled, self.wk = pulled_state_wk(
                cc, self._f, t, self.wk, halo=halo,
                reduce=None if self.mesh is None
                else self.mesh.add_in_rank_order)
            self._f, _, u = step_tail(cc, self._f, pulled)
        elif self.field is None:
            self._f, _, u = step_tail(cc, self._f,
                                      pulled_state(cc, self._f, t, halo=halo))
        else:
            self._f, _, u = step_tail(
                cc, self._f, pulled_state(cc, self._f, t, halo=halo),
                self._force_field())
        u_proj = project(u, sc.blocked_axes)
        comp = None
        if self.div_fix:
            d = defect(u_proj, sc.nbr_block, sc.bcs, self._u_halo(u_proj))
            comp = torch.where(sc.fluid, -d, torch.zeros_like(d))
        self._g, c = transport_pass(
            self._g, t, phi7(u_proj), sc.nbr_block, sc.bcs, sc.omega,
            sc.inv_tau, comp, sc.source, sc.fluid, sc.dirichlet, g_halo)
        return c, u

    def _advance(self, n_steps: int, series, energy=None) -> None:
        from lbm_tpu_torch.kernels import collide_stream as K
        from lbm_tpu_torch.kernels import scalar_stream as S

        if self.backend == "kernel":
            # the flow kernel's per-step velsum samples (not read here)
            vs = torch.empty(n_steps, dtype=torch.float64,
                             device=self.cc.device)
        for k in range(n_steps):
            t = self.t + k
            if self.backend == "kernel":
                # both kernels read the pre-step g; only the scalar
                # kernel writes the spare one
                K.step(self._f, self._f_spare, self.cc, vs, k, t,
                       field=self.field,
                       g=None if self.field is None else self._g,
                       wk=self.wk, prime=k == 0)
                S.scalar_stream(self._g, self._g_spare, self.sc, t,
                                f=self._f_spare, series=series, slot=k)
                self._f, self._f_spare = self._f_spare, self._f
                self._g, self._g_spare = self._g_spare, self._g
            else:
                c, u = self._dense_step(t)
                if series is not None:
                    series[k] = plane_means(c, self.sc.bcs)
                if energy is not None:
                    energy[k] = torch.where(
                        self.sc.fluid[None], u * u,
                        torch.zeros((), device=u.device)).sum(
                            dtype=torch.float64)
        self.t += n_steps
        if self.mesh is not None and self.wk is not None \
                and not self.mesh.same_on_every_rank(self.wk):
            raise RuntimeError(
                f"rank {self.mesh.rank}: the ranks' windkessel P_c differ "
                f"at step {self.t} (this rank's {self.wk.tolist()}): the "
                "replicated carry drifted")

    def run(self, n_steps: int, record: Optional[list] = None):
        """Advance flow and scalar n_steps; record as in
        ScalarTransport.run."""
        series = self._series(n_steps, record)
        self._advance(n_steps, series)
        return self._columns(series, record)

    def _window_macro(self):
        """macro() of the rows this process holds."""
        from lbm_tpu_torch.engine.step import init_override, macro_fields
        from lbm_tpu_torch.kernels import collide_stream as K

        if self.backend == "dense":
            return macro_fields(self.cc, self._f)
        rho, u = K.macro(self._f, self.cc.force)
        return init_override(self.cc, rho, u)

    def macro(self):
        """(rho, u) of the live flow: moments at fluid cells, the init
        values elsewhere; under a mesh the whole box's, on every rank."""
        rho, u = self._window_macro()
        if self.mesh is None:
            return rho, u
        return self._whole(rho, 0), self._whole(u, 1)


__all__ = ["ScalarTransport", "CoupledTransport", "ScalarCase", "ScalarBC",
           "ScalarShard", "compile_scalar", "compile_scalar_shard",
           "crossing_channels", "footprint_lists", "scalar_cell_ids",
           "scalar_touched", "phi7", "project", "pull_axis", "tau_g_of",
           "bc_geometry",
           "blocking_tables", "dirichlet_walls", "defect", "transport_pass",
           "live_velocity", "plane_means", "Q7", "E7", "OPP7", "W7"]
