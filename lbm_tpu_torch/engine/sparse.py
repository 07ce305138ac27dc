"""The live-cell (sparse) backend: the D3Q19 step over the non-DEAD cells
only (torch port of lbm_tpu/engine/sparse.py).

  - the state is f_s, (19, n_live) float32 on the run's device, over the
    live cells in compaction order (z-major, x fastest:
    geometry/mask.compact_index); lbm_tpu pads n_live to a lane multiple,
    a TPU layout the port has no use for;
  - streaming is one gather: nbr_idx[i, k] is the compact id of cell
    k - e_i (wrapped on every axis, as the dense roll; a DEAD source,
    reachable from non-fluid cells only, clamped to 0), row 0 the cell
    itself; the fused half-way bounce-back selects the cell's own opposite
    population where nbr_wall[i, k], MOVING sources add the Ladd term;
  - Bouzidi curved walls overwrite their links in the flattened (19 *
    n_live) pulled state: value = a f[opp] + b_up up + b_loc f[i] with up
    direction opp(i)'s own direct pull, as the dense step applies them
    (core/bouzidi.apply_links);
  - each NEE boundary rewrites its consumer plane's live cells, a list of
    unique compact ids (SparseBC.ids), so every write is deterministic;
    a windkessel outlet's rho* takes its carried P_c and the outward flux
    of the plane's pre-step velocity, as the dense step's;
  - the moments, collision and Guo source are the dense step's own
    functions (engine/step.step_tail) on (19, n_live) tensors, so with
    the same pulled state the two backends agree bit for bit; non-fluid
    live cells keep their f.

f_standard's dense layout comes back through scatter_dense (zeros, or
`fill`, at DEAD cells); `gather_live` takes a dense state's live cells in
compaction order (a flat index_select, also how the kernel backend's
wall shear stress reads the live cells out of its state).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from lbm_tpu_torch.core.bouzidi import apply_links, flat_links, link_table
from lbm_tpu_torch.core.lattice import D3Q19, momentum, phi
from lbm_tpu_torch.core.rheology import normalize_closure
from lbm_tpu_torch.engine.compile import (
    CompiledBC,
    canonical_device,
    compile_bcs,
    has_windkessel,
    mrt_of,
    tau_minus_of,
)
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.engine.step import (
    macro_fields,
    moving_bb_terms,
    step_tail,
    velocity,
    windkessel_flux,
    windkessel_rho,
    windkessel_update,
)
from lbm_tpu_torch.geometry.mask import CellType, compact_index

_E = D3Q19.E
_OPP = D3Q19.OPP
_OPP_IDX = [int(o) for o in _OPP]


@dataclasses.dataclass
class SparseBC(CompiledBC):
    """One NEE boundary on the compacted layout: a CompiledBC whose (A, B)
    plane tables are taken at the plane's live cells, ids their (K,)
    compact ids (valid (D, K), phi_star (D, K), phi_star_series (T, D,
    K), flow_weight (K,))."""

    ids: Optional[torch.Tensor] = None   # (K,) int64 compact ids


@dataclasses.dataclass(eq=False)
class SparseCase:
    name: str
    n_live: int
    tau: float
    device: torch.device
    fluid: torch.Tensor        # (n,) bool
    nbr_idx: torch.Tensor      # (19, n) int64 pull-source ids (row 0: k)
    nbr_wall: torch.Tensor     # (19, n) bool
    bcs: list
    rho0: torch.Tensor         # (n,) f32
    u0: torch.Tensor           # (3, n) f32
    index: np.ndarray          # (X, Y, Z) compact id, -1 at DEAD cells
    live_flat: torch.Tensor    # (n,) int64 C-order flat ids of the cells
    velsum_offset: float
    usq_offset: float
    spec: CaseSpec
    tau_minus: Optional[float] = None
    mrt_k: Optional[np.ndarray] = None
    mrt_kf: Optional[np.ndarray] = None
    closure: Optional[tuple] = None
    force: Optional[tuple] = None
    wall_velocity: Optional[tuple] = None
    nbr_moving: Optional[torch.Tensor] = None   # (19, n) bool
    # Bouzidi links over the flattened (19 * n) state
    # (core/bouzidi.flat_links) or None
    links: Any = None

    @property
    def shape(self) -> tuple:
        return tuple(self.spec.shape)


def _live_cells(mask: np.ndarray, index: np.ndarray, n_live: int):
    """(coords (n, 3) in compaction order, their C-order flat ids)."""
    nx, ny, nz = mask.shape
    t_ids = np.flatnonzero(np.ascontiguousarray(
        np.transpose(mask, (2, 1, 0))) != CellType.DEAD)
    z, rem = np.divmod(t_ids, ny * nx)
    y, x = np.divmod(rem, nx)
    live = np.stack([x, y, z], axis=1)
    assert len(live) == n_live
    assert (index[x, y, z] == np.arange(n_live)).all(), \
        "compaction order mismatch"
    return live, (x * ny + y) * nz + z


def _sparse_bc(cbc: CompiledBC, live: np.ndarray, index: np.ndarray,
               device) -> SparseBC:
    """A compiled plane boundary's tables at its consumer plane's live
    cells (every live cell of the plane; validity per direction from the
    shifted valid masks, as the dense tables)."""
    lat = [a for a in range(3) if a != cbc.axis]
    plane_live = live[live[:, cbc.axis] == cbc.consumer_coord]
    ids = index[plane_live[:, 0], plane_live[:, 1], plane_live[:, 2]]
    la = torch.from_numpy(plane_live[:, lat[0]])
    lb = torch.from_numpy(plane_live[:, lat[1]])

    def take(t):
        return None if t is None else t[..., la, lb].contiguous().to(device)

    fields = {f.name: getattr(cbc, f.name)
              for f in dataclasses.fields(CompiledBC)}
    fields.update(valid=take(cbc.valid), phi_star=take(cbc.phi_star),
                  phi_star_series=take(cbc.phi_star_series),
                  flow_weight=take(cbc.flow_weight), window=None)
    return SparseBC(**fields,
                    ids=torch.from_numpy(ids.astype(np.int64)).to(device))


def compile_sparse(spec: CaseSpec, device="cpu") -> SparseCase:
    """The compacted tables of a case on `device` (lbm_tpu's
    compile_sparse without the lane padding)."""
    device = canonical_device(device)
    mask = np.asarray(spec.mask)
    shape = np.array(mask.shape)
    index, n = compact_index(mask)
    live, live_flat = _live_cells(mask, index, n)
    cell_mask = mask[live[:, 0], live[:, 1], live[:, 2]]
    fluid = cell_mask == CellType.FLUID

    nbr_idx = np.zeros((19, n), np.int64)
    nbr_idx[0] = np.arange(n)
    nbr_wall = np.zeros((19, n), bool)
    has_moving = spec.wall_velocity is not None
    nbr_moving = np.zeros((19, n), bool) if has_moving else None
    for i in range(1, 19):
        src = (live - _E[i]) % shape
        sid = index[src[:, 0], src[:, 1], src[:, 2]]
        smask = mask[src[:, 0], src[:, 1], src[:, 2]]
        nbr_wall[i] = smask == CellType.WALL
        if has_moving:
            nbr_moving[i] = smask == CellType.MOVING
        nbr_idx[i] = np.where(sid >= 0, sid, 0)

    links = None
    if spec.wall_sdf is not None:   # over the (19 * n) compacted state
        links = flat_links(link_table(mask, spec.wall_sdf), n, device,
                           index.ravel())

    bcs = [_sparse_bc(b, live, index, device)
           for b in compile_bcs(spec, mask, "cpu")]
    rho0 = np.asarray(spec.rho0, np.float32)[live[:, 0], live[:, 1],
                                             live[:, 2]]
    u0 = np.asarray(spec.u0, np.float32)[:, live[:, 0], live[:, 1],
                                         live[:, 2]]
    speed0 = np.sqrt((u0.astype(np.float64) ** 2).sum(axis=0))[~fluid]
    mrt_k, mrt_kf = mrt_of(spec)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SparseCase(
        name=spec.name,
        n_live=n,
        tau=float(spec.tau),
        device=device,
        fluid=dev(fluid),
        nbr_idx=dev(nbr_idx),
        nbr_wall=dev(nbr_wall),
        bcs=bcs,
        rho0=dev(rho0),
        u0=dev(u0),
        index=index,
        live_flat=dev(live_flat.astype(np.int64)),
        velsum_offset=float(speed0.sum()),
        usq_offset=float((speed0 ** 2).sum()),
        spec=spec,
        tau_minus=tau_minus_of(spec),
        mrt_k=mrt_k,
        mrt_kf=mrt_kf,
        closure=normalize_closure(spec.smagorinsky_cs, spec.rheology),
        force=spec.force,
        wall_velocity=spec.wall_velocity,
        nbr_moving=None if nbr_moving is None else dev(nbr_moving),
        links=links,
    )


def initial_f_sparse(sc: SparseCase):
    """f_s(0) = feq(rho0, u0) at every live cell."""
    return (sc.rho0[None] * phi(sc.u0)).contiguous()


def _bc_apply(pulled, f_s, bc: SparseBC, t: int, force=None, wk_p=None):
    """The NEE rewrite of one boundary's consumer cells, in place: the
    dense apply_bc_fixup's arithmetic on the (19, K) gathered cells. A
    windkessel outlet takes its carried P_c wk_p and returns (pulled,
    P_c')."""
    src = f_s[:, bc.ids]                                   # (19, K)
    rho_p, mom = momentum(src)
    u_p = velocity(rho_p, mom, force)
    phi_nbr = phi(u_p, dirs=bc.dirs)                       # (D, K)
    phi_star = (phi_nbr if bc.u_mode == "extrapolate"
                else bc.phi_star_at(t))
    p_new = None
    if bc.windkessel is not None:
        if wk_p is None:
            raise ValueError("a windkessel outlet needs its carried P_c "
                             "(make_sparse_step_wk / pulled_sparse_wk)")
        q = windkessel_flux(u_p[bc.axis], bc)
        p_new, p_in = windkessel_update(wk_p, q, bc.windkessel)
        rho_star = windkessel_rho(bc, p_in)
    elif bc.rho_fixed is None:
        rho_star = rho_p[None]
    else:
        rho_star = bc.rho_fixed
    val = rho_star * phi_star + (src[list(bc.dirs)]
                                 - rho_p[None] * phi_nbr) * bc.omega
    for d, i in enumerate(bc.dirs):
        cur = pulled[i, bc.ids]
        pulled[i, bc.ids] = torch.where(bc.valid[d], val[d], cur)
    return pulled if wk_p is None else (pulled, p_new)


def _streamed_sparse(sc: SparseCase, f_s, bb=None):
    """Gather stream + fused bounce-back (half-way or Bouzidi) + moving
    walls on the compacted layout, before any boundary rewrite."""
    own_opp = f_s[_OPP_IDX]
    pulled = torch.where(sc.nbr_wall, own_opp,
                         torch.gather(f_s, 1, sc.nbr_idx))
    if sc.wall_velocity is not None:
        if bb is None:
            bb = moving_bb_terms(sc.wall_velocity)
        terms = torch.from_numpy(bb).to(f_s.device)[:, None]
        pulled = torch.where(sc.nbr_moving, own_opp + terms, pulled)
    if sc.links is not None:
        apply_links(pulled, f_s, sc.links)
    return pulled


def pulled_sparse(sc: SparseCase, f_s, t: int, bb=None):
    """The pre-collision pulled state on the compacted layout: the sparse
    mirror of engine/step.pulled_state, shared by the step and the stress
    diagnostics. A case with windkessel outlets uses pulled_sparse_wk."""
    if has_windkessel(sc.bcs):
        raise ValueError("the case has windkessel outlets; use "
                         "pulled_sparse_wk with the carried state")
    pulled = _streamed_sparse(sc, f_s, bb)
    for bc in sc.bcs:
        pulled = _bc_apply(pulled, f_s, bc, t, sc.force)
    return pulled


def pulled_sparse_wk(sc: SparseCase, f_s, t: int, wk, bb=None):
    """pulled_sparse of a case with windkessel outlets: wk is the (n_wk,)
    fp32 carried P_c (compile.wk_init's order); returns (pulled, wk')."""
    pulled = _streamed_sparse(sc, f_s, bb)
    wk_new = []
    for bc in sc.bcs:
        if bc.windkessel is not None:
            pulled, p = _bc_apply(pulled, f_s, bc, t, sc.force,
                                  wk_p=wk[bc.wk_index])
            wk_new.append(p)
        else:
            pulled = _bc_apply(pulled, f_s, bc, t, sc.force)
    return pulled, torch.stack(wk_new)


def make_sparse_step(sc: SparseCase) -> Callable:
    """(f_s, t) -> (f_s', rho, u), t the absolute step."""
    if has_windkessel(sc.bcs):
        raise ValueError("the case has windkessel outlets; build the step "
                         "with make_sparse_step_wk")
    bb = (None if sc.wall_velocity is None
          else moving_bb_terms(sc.wall_velocity))

    def step(f_s, t):
        return step_tail(sc, f_s, pulled_sparse(sc, f_s, t, bb))

    return step


def make_sparse_step_wk(sc: SparseCase) -> Callable:
    """The sparse step of a case with windkessel (RCR) outlets: (f_s, t,
    wk) -> (f_s', rho, u, wk')."""
    bb = (None if sc.wall_velocity is None
          else moving_bb_terms(sc.wall_velocity))

    def step(f_s, t, wk):
        pulled, wk_new = pulled_sparse_wk(sc, f_s, t, wk, bb)
        f_new, rho, u = step_tail(sc, f_s, pulled)
        return f_new, rho, u, wk_new

    return step


def scatter_dense(sc: SparseCase, arr_sparse, fill=0.0):
    """(..., n_live) field -> (..., X, Y, Z), `fill` at DEAD cells."""
    lead = tuple(arr_sparse.shape[:-1])
    out = torch.full(lead + (int(np.prod(sc.shape)),), float(fill),
                     dtype=arr_sparse.dtype, device=arr_sparse.device)
    out.view(-1, out.shape[-1]).index_copy_(
        1, sc.live_flat, arr_sparse.reshape(-1, sc.n_live))
    return out.view(lead + sc.shape)


def gather_live(sc: SparseCase, dense):
    """(..., X, Y, Z) field -> (..., n_live) at the live cells, in
    compaction order."""
    lead = tuple(dense.shape[:-3])
    flat = dense.reshape(lead + (-1,))
    return flat.index_select(len(lead), sc.live_flat.to(dense.device))


# lbm_tpu's names for the dense step's tail and moments, which run on the
# compacted cells unchanged
_sparse_step_tail = step_tail
macro_fields_sparse = macro_fields


__all__ = ["SparseBC", "SparseCase", "compile_sparse", "initial_f_sparse",
           "make_sparse_step", "make_sparse_step_wk", "pulled_sparse",
           "pulled_sparse_wk", "macro_fields_sparse", "scatter_dense",
           "gather_live"]
