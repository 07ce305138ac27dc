"""Wrappers for the Hopper collide-stream (K1a + K1b, with K1c's
fluid-cell list and the z planes of K5 + K6), moments (K3), fused-pair
(K2) and row-extract (K4) kernels, their plain PyTorch versions, and
launch counters.

  collide_stream  -> lbm_collide_stream (kernels/csrc/collide_stream.cuh)
  (alias step)       over the box, or lbm_collide_stream_list
                     (collide_stream_list.cuh) over a float32 case's fluid
                     cells (its CompiledCase.fluid_launch: sector-aligned
                     segments of each row's fluid runs, a word of wall
                     links a lane; counted "lbm_collide_stream_list[bgk]"):
                     one whole step in one launch, replacing
                     lbm_tpu/kernels/collide_stream.py::_kernel (BGK and
                     the K1b branches: TRT, Guo force, moving walls,
                     LES/rheology closures, MRT; series phases; live-tile
                     list `tids`, here the fluid-cell list), ::_row_fix and
                     the velsum, and the z-plane boundaries that lbm_tpu
                     fixes after its kernel (::_extract_z_slab,
                     ::_splice_z_plane_inplace and the XLA arithmetic of
                     ::_fix_z_plane_windowed between them): each z plane is
                     one more descriptor of the same pass. Its plain
                     version is step_plain: collide_stream_plain (the x/y
                     planes) and fix_z_plane_plain (each z plane's window
                     again, with its rewrite)
  collide_stream  -> lbm_collide_stream_wk (kernels/csrc/windkessel.cuh,
  with wk=           built from windkessel.cu and windkessel_bf16.cu): the
                     same step with the windkessel (RCR) outlets' flux
                     folded in, replacing the outward flux and RCR update
                     of their carried P_c that lbm_tpu computes in its
                     fixups (engine/step.py apply_bc_fixup, run by
                     ::_fix_xy_plane_windowed and ::_fix_z_plane_windowed
                     after its kernel): each outlet's descriptor derives
                     rho* from P_c and the flux staged from the pre-step
                     state, the footprint's cells write their flux terms
                     of the post-step state, and the launch's one-block
                     reduction commits P_c and stages the next flux, in a
                     fixed order (counted "lbm_collide_stream[bgk+wk]").
                     Its plain version is step_wk_plain
  windkessel_prime -> lbm_windkessel_flux (the same sources): the flux
                     terms and Q of a state the fold did not write, one
                     block an outlet (P_c untouched); collide_stream
                     launches it when needed. Its plain version is
                     wk_terms_plain; windkessel_flux_plain is lbm_tpu's
                     step of the outlets from a pre-step state
  macro           -> lbm_macro, replacing ::packed_macro (with its F/2
                     shift when the case has a force)
  step2           -> lbm_collide_stream2 (kernels/csrc/collide_stream2.cuh):
                     two whole steps of a case whose boundaries all lie on
                     x/y planes, replacing ::_kernel2 (two fused steps per
                     round trip, an x-marching (y, z) column, with its
                     live list of column segments)
  extract_rows    -> lbm_extract_rows, replacing ::_extract_rows: x rows
                     of the state as one contiguous chunk, the unit of
                     unpack_state_lowmem's chunked device-to-host read

The collide-stream kernel is a template over the collision branch;
`instance(cc)` names the one a case runs ("bgk", "trt+cy",
"bgk+force", "mrt+moving", ...) and `collision_tables` builds its
by-value operands. With `field=ForceField(buoyancy, c_ref)` and the
scalar state `g` the step runs its force-field instance ("bgk+field",
"trt+field": K1e, the `fforce` mode of lbm_tpu's _kernel): the
Boussinesq force buoyancy (c - c_ref) per fluid cell, c summed from the
cell's seven pre-step g. A wrapper runs the plain version only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises. The kernels
store fluid cells only: `out` must already hold f's non-fluid cells (the
two ping-pong buffers of a run always do), and the plain versions leave
every non-fluid cell as f has it, so the two agree. `launches`
counts kernel launches per entry point and instance ("lbm_collide_stream
[trt+cy]"), one per wrapper call that launched.

With halo=(axis, lo, hi, mask_lo, mask_hi) collide_stream takes one
shard of a box split along x (axis 0) or y (axis 1)
(engine/compile.ShardCase): lbm_collide_stream_halo
(kernels/csrc/collide_stream_halo.cu, one library an axis; K1d: lbm_tpu's
_kernel with halo_axis, and its sharded z fixup) pulls across the shard's
faces from lo and hi, the (5, A, B) planes its ring neighbours sent,
testing walls against mask_lo and mask_hi, their rows' (A, B) labels
(the ShardCase's own: cc.halo(lo, hi) builds the tuple); a shard with a
fluid-cell list launches lbm_collide_stream_halo_list over its
fluid_launch, whose face rows' links come from those rows. Their plain
versions take the same halo, and their counters end in "+halo"
("lbm_collide_stream[bgk+halo]", "lbm_collide_stream_list[bgk+halo]");
counter_name gives the one a case's step counts. A shard is float32 and
has no force field, as lbm_tpu's sharded path.

The state is float32 or bfloat16 (bf16 storage, lbm_tpu's pack_state
dtype=bfloat16): the bf16 kernels and plain versions widen every load to
fp32, compute as in fp32 and narrow once with round-to-nearest-even when
they store, once a step for collide_stream (the plain z-plane fixup's
narrowing of its cells is that step's) and once a pair for step2,
whose mid state stays fp32 as lbm_tpu's does. The bf16 kernels are
separate instances (counted as "lbm_collide_stream[trt+bf16]",
"lbm_macro[bf16]", "lbm_extract_rows[bf16]"); the force field has none.
The bf16 step is the paired kernel (collide_stream_pair_kernel): a thread
an interior pair of z-neighbour cells (packed bf16 loads and stores, both
cells collided at once) or a cell, over pair_launch's list or the box,
its divisions exact without the IEEE slow path (div_exact); bit for bit
the same step. div_exact_check runs that division against IEEE a / b
over all 2^32 dividends of one divisor on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import D3Q19, momentum
from lbm_tpu_torch.core.rheology import closure_constants
from lbm_tpu_torch.engine.compile import (
    SEG,
    CompiledBC,
    CompiledCase,
    TILE,
    fuse2_refusal,
    has_windkessel,
    kernel_refusal,
    live_block_ids,
    wk_footprint,
)
from lbm_tpu_torch.engine.step import (
    apply_bc_fixup,
    boussinesq_force,
    collide_cells,
    fluid_speed_sum,
    guo_constants,
    guo_rates,
    half_force,
    halo_ext,
    halo_mask_ext,
    moving_bb_terms,
    pulled_state,
    step_tail,
    velocity,
    windkessel_rho,
    windkessel_update,
)
from lbm_tpu_torch.geometry.mask import CellType

launches: dict[str, int] = {}

# the state's storage types
STORE_DTYPES = (torch.float32, torch.bfloat16)

# ints per boundary descriptor row: kBCInts in csrc/collide_stream.cu
_BC_ROW = 11

# The collision descriptor (struct Collision in csrc/collide_stream.cu):
# an int row and a float row, at these offsets (the enums CInt/CFloat
# there; a CPU test compares the two).
CINT = {"coll": 0, "closure": 1, "force": 2, "moving": 3, "iters": 4,
        "square": 5, "n": 6}
CFLOAT = {"tau": 0, "two_tau": 1, "two_tau_m": 2, "cp": 3, "half_force": 4,
          "force": 7, "e_f": 10, "cm_odd": 29, "bb": 48, "mrt_k": 67,
          "t0": 428, "lam": 429, "lo": 430, "hi": 431, "c": 432, "cm": 438,
          "buoy": 439, "c_ref": 442, "n": 443}
# CINT["force"]: no force, the constant CaseSpec.force, the force field
NO_FORCE, CONST_FORCE, FIELD_FORCE = 0, 1, 2
COLLISIONS = ("bgk", "trt", "mrt")
CLOSURES = (None, "smag", "plaw", "cy", "casson")
# constants of each closure kind, in the order of CFLOAT["c"]
_CLOSURE_C = {"smag": ("k",), "plaw": ("em1", "c3k"),
              "cy": ("dnu3", "base", "ea", "ex", "lam"),
              "casson": ("b", "cc", "dd")}


@dataclasses.dataclass(frozen=True)
class ForceField:
    """The Boussinesq force of the thermal route: F = buoyancy (c -
    c_ref) at fluid cells, c the sum of the scalar state's channels."""

    buoyancy: tuple[float, float, float]
    c_ref: float = 0.0


def reset_launches() -> None:
    launches.clear()


def _count(entry: str) -> None:
    launches[entry] = launches.get(entry, 0) + 1


def _bf16(f) -> bool:
    return f.dtype == torch.bfloat16


def _widen(f):
    """The state as float32: a bf16 state widened (exactly), a float32
    one as it is."""
    return f.float() if _bf16(f) else f


def _tagged(name: str, f) -> str:
    """The counter name of an instance on f's storage: 'trt' -> 'trt+bf16'
    for bf16 state."""
    return f"{name}+bf16" if _bf16(f) else name


def instance(cc: CompiledCase, field: ForceField | None = None) -> str:
    """The kernel instance a case runs: its collision, closure kind,
    '+force' (or '+field' with a force field) and '+moving', e.g.
    'trt+cy' or 'bgk+force'."""
    parts = [cc.spec.collision]
    if cc.closure is not None:
        parts.append(cc.closure[0])
    if field is not None:
        parts.append("field")
    elif cc.force is not None:
        parts.append("force")
    if cc.wall_velocity is not None:
        parts.append("moving")
    return "+".join(parts)


def collision_tables(cc: CompiledCase, field: ForceField | None = None):
    """The kernels' collision descriptor of a case: (int32 row, float32
    row) at the CINT/CFLOAT offsets. Every constant is the dense step's,
    rounded to fp32 the same way."""
    ci = np.zeros(CINT["n"], np.int32)
    cf = np.zeros(CFLOAT["n"], np.float32)
    f32 = np.float32
    tau = f32(cc.tau)
    ci[CINT["coll"]] = COLLISIONS.index(cc.spec.collision)
    cf[CFLOAT["tau"]] = tau
    cf[CFLOAT["two_tau"]] = 2 * tau
    if cc.tau_minus is not None:
        cf[CFLOAT["two_tau_m"]] = f32(2.0 * cc.tau_minus)
        cf[CFLOAT["lam"]] = f32((cc.tau - 0.5) * (cc.tau_minus - 0.5))
    if field is not None:
        ci[CINT["force"]] = FIELD_FORCE
        cf[CFLOAT["cp"]], cf[CFLOAT["cm"]] = guo_rates(cc.tau, cc.tau_minus)
        cf[CFLOAT["buoy"]:CFLOAT["buoy"] + 3] = field.buoyancy
        cf[CFLOAT["c_ref"]] = field.c_ref
    elif cc.force is not None:
        e_f, cm_odd, cp, _ = guo_constants(cc.force, cc.tau, cc.tau_minus)
        ci[CINT["force"]] = CONST_FORCE
        cf[CFLOAT["cp"]] = cp
        cf[CFLOAT["half_force"]:CFLOAT["half_force"] + 3] = \
            half_force(cc.force)
        cf[CFLOAT["force"]:CFLOAT["force"] + 3] = cc.force
        cf[CFLOAT["e_f"]:CFLOAT["e_f"] + 19] = e_f
        cf[CFLOAT["cm_odd"]:CFLOAT["cm_odd"] + 19] = cm_odd
    if cc.wall_velocity is not None:
        ci[CINT["moving"]] = 1
        cf[CFLOAT["bb"]:CFLOAT["bb"] + 19] = moving_bb_terms(
            cc.wall_velocity)
    if cc.mrt_k is not None:
        cf[CFLOAT["mrt_k"]:CFLOAT["mrt_k"] + 19 * 19] = cc.mrt_k.reshape(-1)
    if cc.closure is not None:
        k = closure_constants(cc.closure, cc.tau)
        ci[CINT["closure"]] = CLOSURES.index(k["kind"])
        ci[CINT["iters"]] = k.get("iters", 0)
        ci[CINT["square"]] = int(k.get("square", False))
        cf[CFLOAT["t0"]] = k["t0"]
        cf[CFLOAT["lo"]] = k.get("lo", 0.0)
        cf[CFLOAT["hi"]] = k.get("hi", 0.0)
        for j, name in enumerate(_CLOSURE_C[k["kind"]]):
            cf[CFLOAT["c"] + j] = k[name]
    return ci, cf


def _field_tensor(cc: CompiledCase, field, g):
    """The (3, X, Y, Z) force of `field` from the scalar state g, or
    cc.force without a field."""
    if field is None:
        return cc.force
    return boussinesq_force(g, cc.fluid, field.buoyancy, field.c_ref)


def collide_stream_plain(f, cc: CompiledCase, t: int, field=None, g=None,
                         halo=None, rho_wk=None):
    """The dense step at absolute step t with the x/y-plane boundaries
    only (those lbm_tpu's kernel rewrites in its rows; step_plain adds
    the z planes) plus the fluid velsum: (f', sum_fluid |u|) with the sum
    a float64 0-dim tensor and f' in f's dtype (a bf16 f widened, stepped
    in fp32, narrowed once). field, g: the force field and the pre-step
    scalar state it is built from. halo: a shard's (axis, lo, hi,
    mask_lo, mask_hi). rho_wk: the (n_wk,) rho* of the windkessel
    outlets (windkessel_flux_plain's). On a case without z planes it is
    the plain version of collide_stream, and of the fused pair's single
    step."""
    f32 = _widen(f)
    pulled = pulled_state(cc, f32, t, cc.kernel_bcs, halo, rho_wk)
    f_new, _, u = step_tail(cc, f32, pulled, _field_tensor(cc, field, g))
    return f_new.to(f.dtype), fluid_speed_sum(cc, u)


def _speed(u):
    return torch.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])


def fix_z_plane_plain(f_src, f_out, cc: CompiledCase, bc: CompiledBC,
                      t: int, field=None, g=None, halo=None, rho_wk=None):
    """One z-plane boundary's fixup over its window: the step of the
    window's consumer-plane cells again, from the pre-step f_src, with
    this boundary's NEE rewrite; writes their fluid cells into f_out in
    place (narrowed to f_out's dtype). Returns sum |u_fixed| - sum
    |u_pre-NEE| over those cells (float64 0-dim), the velsum correction.
    halo: a shard's, as collide_stream_plain takes it (the window's rows
    on the shard's faces pull from its planes). rho_wk: the windkessel
    outlets' rho*, as collide_stream_plain takes it."""
    f_src = _widen(f_src)
    x0, x1, y0, y1 = bc.window
    c = bc.consumer_coord
    nx, ny, nz = cc.shape
    xs = torch.arange(x0, x1, device=f_src.device)[:, None]
    ys = torch.arange(y0, y1, device=f_src.device)[None, :]
    bb = (None if cc.wall_velocity is None
          else moving_bb_terms(cc.wall_velocity))
    src, mask, axis = f_src, cc.mask, None
    if halo is not None:
        axis, lo, hi, mask_lo, mask_hi = halo
        src = halo_ext(f_src, axis, lo, hi)
        mask = halo_mask_ext(cc.mask, axis, mask_lo, mask_hi)

    def source(v, e, n, a):
        # the shard axis indexes the ring-extended rows; the others wrap
        return v - e + 1 if a == axis else (v - e) % n

    pulled = [f_src[0, x0:x1, y0:y1, c]]
    for i in range(1, D3Q19.Q):
        ex, ey, ez = (int(v) for v in D3Q19.E[i])
        sx, sy, sz = (source(xs, ex, nx, 0), source(ys, ey, ny, 1),
                      (c - ez) % nz)
        nbr = mask[sx, sy, sz]
        own_opp = f_src[D3Q19.OPP[i], x0:x1, y0:y1, c]
        v = torch.where(nbr == CellType.WALL, own_opp, src[i, sx, sy, sz])
        if bb is not None:
            v = torch.where(nbr == CellType.MOVING, own_opp + float(bb[i]), v)
        pulled.append(v)
    pulled = torch.stack(pulled)[..., None]          # (19, wx, wy, 1)
    force = cc.force
    if field is not None:
        force = _field_tensor(cc, field, g)[:, x0:x1, y0:y1, c:c + 1]
    speed_before = _speed(velocity(*momentum(pulled), force))
    window = dataclasses.replace(
        bc, consumer_coord=0, valid=bc.valid[:, x0:x1, y0:y1],
        phi_star=(None if bc.phi_star is None
                  else bc.phi_star[:, x0:x1, y0:y1]),
        phi_star_series=(None if bc.phi_star_series is None
                         else bc.phi_star_series[:, :, x0:x1, y0:y1]))
    apply_bc_fixup(pulled, f_src[:, x0:x1, y0:y1, c:c + 1], window, t,
                   cc.force, rho_star=(None if bc.windkessel is None
                                       else rho_wk[bc.wk_index]))
    post, _, u = collide_cells(cc, pulled, force)
    post = post[..., 0]
    fluid = cc.fluid[x0:x1, y0:y1, c]
    plane = f_out[:, x0:x1, y0:y1, c]
    plane.copy_(torch.where(fluid[None], post, plane))
    diff = _speed(u).double() - speed_before.double()
    return torch.where(fluid[..., None], diff,
                       torch.zeros_like(diff)).sum(dtype=torch.float64)


def step_plain(f, cc: CompiledCase, t: int, field=None, g=None, halo=None,
               rho_wk=None):
    """The plain version of the collide-stream launch: (f', velsum) with
    the velsum a float64 0-dim tensor and f' in f's dtype. rho_wk: the
    windkessel outlets' rho* this step (windkessel_flux_plain's or
    wk_commit_plain's)."""
    f_new, vs = collide_stream_plain(f, cc, t, field, g, halo, rho_wk)
    for bc in cc.z_bcs:
        if bc.window is not None:
            vs = vs + fix_z_plane_plain(f, f_new, cc, bc, t, field, g, halo,
                                        rho_wk)
    return f_new, vs


# the windkessel kernels' block (kWKBlock in csrc/d3q19.cuh): the plain
# versions sum in their order
WK_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class WKLists:
    """The windkessel outlets' footprints as the kernels take them, in the
    carried vector's order: outlet k's cells are cells[begin:end]
    (ascending cell ids of its consumer-plane footprint, compile
    .wk_footprint) with their fp32 weights, rows[k] = (axis, begin, end),
    and floats[k] = (flow_sign, Rp, C, 1 + 1/(Rd C), rho_fixed), the last
    three composed in fp32. foot[k] = row * 3 + axis of the footprint's
    k-th fluid cell in that order: the cell the fold's launch list
    (cc.fluid_cells) holds at its k-th place. bc_rows: each of
    cc.step_bcs' outlet index (wk_index) or -1, as the fold's launch
    takes its descriptor rows."""

    cells: torch.Tensor
    weights: torch.Tensor
    rows: np.ndarray
    floats: np.ndarray
    foot: torch.Tensor
    bc_rows: np.ndarray


def _wk_bcs(cc: CompiledCase) -> list:
    """The windkessel outlets in boundary order, the carried vector's."""
    return [bc for bc in cc.bcs if bc.windkessel is not None]


def wk_lists(cc: CompiledCase) -> WKLists:
    """The case's WKLists, built once (the whole footprint of each
    outlet, whatever its valid window)."""
    per_case = _scratch.setdefault(cc, {})
    if "wk" not in per_case:
        cells, weights, rows, floats, foot = [], [], [], [], []
        fluid = cc.fluid.reshape(-1).cpu().numpy()
        begin = 0
        for bc in _wk_bcs(cc):
            ids, w = wk_footprint(bc, cc.shape)
            cells.append(ids)
            weights.append(w)
            rows.append((bc.axis, begin, begin + len(ids)))
            foot.append((begin + np.flatnonzero(fluid[ids])) * 3 + bc.axis)
            begin += len(ids)
            rp, cap, rd = (np.float32(v) for v in bc.windkessel)
            floats.append((bc.flow_sign, rp, cap,
                           np.float32(1.0) + np.float32(1.0) / (rd * cap),
                           np.float32(bc.rho_fixed)))
        cells, foot = np.concatenate(cells), np.concatenate(foot)
        listed = cc.fluid_cells
        if listed is None or not np.array_equal(
                listed[:len(foot)].cpu().numpy(), cells[foot // 3]):
            raise ValueError("the case's launch list does not start with "
                             "its windkessel footprint's fluid cells "
                             "(compile.fold_cell_ids)")
        per_case["wk"] = WKLists(
            cells=torch.from_numpy(cells).to(cc.device),
            weights=torch.from_numpy(np.concatenate(weights)).to(cc.device),
            rows=np.asarray(rows, np.int32),
            floats=np.asarray(floats, np.float32),
            foot=torch.from_numpy(foot.astype(np.int32)).to(cc.device),
            bc_rows=np.asarray([-1 if bc.wk_index is None else bc.wk_index
                                for bc in cc.step_bcs], np.int32))
    return per_case["wk"]


def _ordered_sum(v):
    """The windkessel kernels' fixed-order fp32 sum of a 1-D tensor:
    WK_BLOCK strided partials, each summed from 0 in order, then a
    halving tree."""
    pad = (-v.numel()) % WK_BLOCK
    v = torch.cat([v, v.new_zeros(pad)]).reshape(-1, WK_BLOCK)
    acc = v.new_zeros(WK_BLOCK)
    for row in v:
        acc = acc + row
    s = WK_BLOCK // 2
    while s > 0:
        acc = torch.cat([acc[:s] + acc[s:2 * s], acc[s:]])
        s //= 2
    return acc[0]


def wk_terms_plain(f, cc: CompiledCase):
    """The plain version of `windkessel_prime` (the fold's stage): (terms,
    Q), fp32, from the state f (a bf16 f widened): each footprint row's
    term flow_weight * u[axis] (u the moments with the F/2 shift) and each
    outlet's Q = flow_sign * the sum of its terms in the kernels' order."""
    lists = wk_lists(cc)
    rho, mom = momentum(_widen(f).reshape(19, -1)[:, lists.cells.long()])
    u = velocity(rho, mom, cc.force)
    terms = torch.empty_like(lists.weights)
    q = []
    for (axis, begin, end), fl in zip(lists.rows.tolist(), lists.floats):
        terms[begin:end] = lists.weights[begin:end] * u[axis, begin:end]
        q.append(float(fl[0]) * _ordered_sum(terms[begin:end]))
    return terms, torch.stack(q)


def wk_commit_plain(cc: CompiledCase, wk, q):
    """(P_c', rho*), each (n_wk,) fp32: one backward-Euler step of each
    outlet's carried P_c (wk) with the flux q, as engine/step
    .windkessel_update, and its rewrite's rho*."""
    p_out, rho_out = [], []
    for k, bc in enumerate(_wk_bcs(cc)):
        p_new, p_in = windkessel_update(wk[k], q[k], bc.windkessel)
        p_out.append(p_new)
        rho_out.append(windkessel_rho(bc, p_in))
    return torch.stack(p_out), torch.stack(rho_out)


def windkessel_flux_plain(f, cc: CompiledCase, wk):
    """The windkessel outlets' step from the pre-step f, as lbm_tpu's
    fixups take it: (wk', rho*), each (n_wk,) fp32, with Q summed in the
    kernels' order (wk_terms_plain) and P_c stepped as
    engine/step.windkessel_update. The fold (step_wk_plain) gives the
    same values from the Q it staged."""
    return wk_commit_plain(cc, wk, wk_terms_plain(f, cc)[1])


def step_wk_plain(f, cc: CompiledCase, t: int, wk, q):
    """The plain version of the fold launch and its reduction at absolute
    step t: (f', velsum, P_c', terms', Q'). wk: the carried P_c; q: the
    staged Q, the flux of f (wk_terms_plain(f)). rho* and P_c' are
    windkessel_flux_plain's with that Q, f' and the velsum step_plain's
    with that rho*, and (terms', Q') the stage of f' that the next launch
    reads (the kernel writes the terms of the footprint's fluid cells; a
    non-fluid cell's term is its state's, which no step changes)."""
    p_new, rho = wk_commit_plain(cc, wk, q)
    f_new, vs = step_plain(f, cc, t, rho_wk=rho)
    terms, q_new = wk_terms_plain(f_new, cc)
    return f_new, vs, p_new, terms, q_new


def _check_wk(wk, cc: CompiledCase, name: str = "wk, their carried P_c"):
    n = len(wk_lists(cc).rows)
    if wk is None or not torch.is_tensor(wk) or wk.dtype != torch.float32 \
            or tuple(wk.shape) != (n,) or not wk.is_contiguous() \
            or wk.device != cc.device:
        raise ValueError(f"the case's {n} windkessel outlets need {name}: "
                         f"a contiguous float32 ({n},) tensor on "
                         f"{cc.device}")


@dataclasses.dataclass
class WKStage:
    """The fold's stage of a case, on its device: the footprint's terms
    and each outlet's Q (fp32), and `of`, the key (_state_key) of the
    state they were staged from, or None."""

    terms: torch.Tensor
    q: torch.Tensor
    of: tuple | None = None


def _state_key(f) -> tuple:
    """A state's identity for the stage: its storage and torch's version
    counter of it (bumped by every in-place write torch makes; a kernel's
    write is not one)."""
    return f.data_ptr(), f._version


def wk_stage(cc: CompiledCase) -> WKStage:
    """The case's WKStage, made at first use (nothing staged)."""
    per_case = _scratch.setdefault(cc, {})
    if "wk_stage" not in per_case:
        lists = wk_lists(cc)
        per_case["wk_stage"] = WKStage(
            terms=torch.zeros_like(lists.weights),
            q=torch.zeros(len(lists.rows), dtype=torch.float32,
                          device=cc.device))
    return per_case["wk_stage"]


def windkessel_prime(f, cc: CompiledCase) -> WKStage:
    """Prime the fold from the state f (float32 or bfloat16): every
    footprint term and each outlet's Q into the case's stage (wk_stage),
    P_c untouched. One launch of lbm_windkessel_flux on a CUDA tensor,
    its plain version (wk_terms_plain) on the CPU. collide_stream calls it
    when the state it is given is not the last fold launch's output."""
    _check_state(f, cc, "f")
    stage = wk_stage(cc)
    if f.device.type == "cpu":
        terms, q = wk_terms_plain(f, cc)
        stage.terms.copy_(terms)
        stage.q.copy_(q)
        stage.of = _state_key(f)
        return stage
    from lbm_tpu_torch.kernels._build import check, load_wk_library

    lib = load_wk_library().lib
    lists = wk_lists(cc)
    half = (None if cc.force is None
            else np.asarray(half_force(cc.force), np.float32))
    name = "lbm_windkessel_flux[bf16]" if _bf16(f) else "lbm_windkessel_flux"
    launch = (lib.lbm_windkessel_flux_bf16 if _bf16(f)
              else lib.lbm_windkessel_flux)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = launch(f.data_ptr(), f[0].numel(), len(lists.rows),
                     lists.rows.ctypes.data, lists.floats.ctypes.data,
                     None if half is None else half.ctypes.data,
                     lists.cells.data_ptr(), lists.weights.data_ptr(),
                     stage.terms.data_ptr(), stage.q.data_ptr(), stream)
    check(lib, err, name)
    _count(name)
    stage.of = _state_key(f)
    return stage


def macro_plain(f, force=None):
    """(rho, u) moments of every cell, u = (m + F/2) / rho with a force
    (fp32, from a bf16 state widened)."""
    rho, mom = momentum(_widen(f))
    return rho, velocity(rho, mom, force)


def _check_state(f, cc: CompiledCase, name: str) -> None:
    if f.dtype not in STORE_DTYPES or not f.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 or bfloat16 "
                         "tensor")
    if tuple(f.shape) != (19,) + tuple(cc.shape):
        raise ValueError(f"{name} shape {tuple(f.shape)} != (19, *{cc.shape})")
    if f.device != cc.device:
        raise ValueError(f"{name} is on {f.device}, the case on {cc.device}")


def _check_pair(f, out, cc: CompiledCase, series, slot: int) -> None:
    _check_state(f, cc, "f")
    _check_state(out, cc, "out")
    if out.dtype != f.dtype:
        raise ValueError(f"out is {out.dtype}, f {f.dtype}: one storage "
                         "type")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {f.device}")
    if out.data_ptr() == f.data_ptr():
        raise ValueError("the step reads neighbors: out must not be f")
    if series.dtype != torch.float64 or series.device != f.device \
            or series.dim() != 1 or not 0 <= slot < series.numel():
        raise ValueError("series must be a 1-D float64 tensor on f's device "
                         "with the slot inside it")


def _bc_tables(cc: CompiledCase, bcs=None, t: int = 0):
    """Host descriptor rows and device table pointers for the kernels
    (default: the collide-stream kernel's x/y-plane boundaries), with
    series boundaries at their phase of step t."""
    bcs = cc.kernel_bcs if bcs is None else bcs
    n = len(bcs)
    ints = np.zeros((max(n, 1), _BC_ROW), np.int32)
    floats = np.zeros((max(n, 1), 2), np.float32)
    valid = (ctypes.c_void_p * max(n, 1))()
    phis = (ctypes.c_void_p * max(n, 1))()
    for b, bc in enumerate(bcs):
        lat_a = cc.shape[1] if bc.axis == 0 else cc.shape[0]
        extrap = bc.u_mode == "extrapolate"
        ints[b, :6] = (bc.axis, bc.consumer_coord, lat_a,
                       bc.rho_fixed is not None, extrap, len(bc.dirs))
        ints[b, 6 : 6 + len(bc.dirs)] = bc.dirs
        floats[b] = (0.0 if bc.rho_fixed is None else bc.rho_fixed, bc.omega)
        valid[b] = bc.valid.data_ptr()
        phis[b] = None if extrap else bc.phi_star_at(t).data_ptr()
    return ints, floats, valid, phis


# The wrappers' scratch per case, dropped with the case: {(kernel, bc
# ids): (bcs, descriptor rows, partials)} and {"collision": (name, int
# row, float row)}. An entry holds its boundaries, so their ids stay
# unique while it lives.
_scratch: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _launch_scratch(cc: CompiledCase, kernel: str, bcs, t: int, n: int):
    """The descriptor rows of `bcs` at step t and an (n,) float64 buffer
    for the kernel's block partials, both built once per case and
    boundary list: only the phi* pointers of series boundaries move with
    t. (Each launch's reduction reads the partials before the next launch
    on the stream writes them.)"""
    per_case = _scratch.setdefault(cc, {})
    key = (kernel,) + tuple(id(bc) for bc in bcs)
    entry = per_case.get(key)
    if entry is None:
        entry = per_case[key] = (list(bcs), _bc_tables(cc, bcs, t), {})
    _, tab, partials = entry
    phis = tab[3]
    for b, bc in enumerate(bcs):
        if bc.u_mode == "series":
            phis[b] = bc.phi_star_at(t).data_ptr()
    if n not in partials:
        partials[n] = torch.empty(n, dtype=torch.float64, device=cc.device)
    return tab, partials[n]


def collision_descriptor(cc: CompiledCase, field: ForceField | None = None):
    """(instance name, int row, float row) of the case (with a force
    field: of its force-field instance), built once. Raises
    NotImplementedError, naming the backend that runs it, for a case the
    kernels refuse (compile.kernel_refusal), on every call."""
    per_case = _scratch.setdefault(cc, {})
    key = ("collision", field)
    if key not in per_case:
        reason = kernel_refusal(cc.spec, field is not None)
        if reason is not None:
            raise NotImplementedError(reason)
        per_case[key] = (instance(cc, field),) + collision_tables(cc, field)
    return per_case[key]


def _check_field(field, g, cc: CompiledCase, f):
    """The pointer of the scalar state a force field reads (None without
    a field), after checking it and f's storage."""
    if field is None:
        if g is not None:
            raise ValueError("g was given without a force field")
        return None
    if _bf16(f):
        raise ValueError("the force field steps float32 state only: "
                         "lbm_tpu's transports take no store_dtype")
    if g is None or g.dtype != torch.float32 or not g.is_contiguous() \
            or tuple(g.shape) != (7,) + tuple(cc.shape) \
            or g.device != cc.device:
        raise ValueError("a force field needs g, a contiguous float32 "
                         f"(7, *{cc.shape}) tensor on {cc.device}")
    return g.data_ptr()


def _check_halo(halo, cc: CompiledCase, f, field) -> None:
    """A shard's halo tuple against its case and state."""
    axis, lo, hi, mask_lo, mask_hi = halo
    if axis not in (0, 1):
        raise ValueError(f"the sharded kernel splits x (0) or y (1), not "
                         f"axis {axis!r}")
    if field is not None or f.dtype != torch.float32:
        raise ValueError("a shard steps float32 state without a force field "
                         "(lbm_tpu's sharded path takes neither bf16 nor the "
                         "transports' field)")
    lat = tuple(n for a, n in enumerate(cc.shape) if a != axis)
    for name, t, dtype, shape in (
            ("lo", lo, torch.float32, (5,) + lat),
            ("hi", hi, torch.float32, (5,) + lat),
            ("mask_lo", mask_lo, torch.int8, lat),
            ("mask_hi", mask_hi, torch.int8, lat)):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != f.device:
            raise ValueError(f"halo {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {f.device}")
    if mask_lo is not getattr(cc, "mask_lo", None) \
            or mask_hi is not getattr(cc, "mask_hi", None):
        raise ValueError("halo mask_lo and mask_hi must be the shard case's "
                         "own (ShardCase.halo), which its plain version reads")


def collide_stream(f, out, cc: CompiledCase, series, slot: int, t: int,
                   all_blocks: bool = False, field: ForceField | None = None,
                   g=None, halo=None, wk=None, prime: bool = False):
    """One whole step of f into out (a different buffer) at absolute step
    t, in one launch, with the case's collision branch and its boundaries
    (cc.step_bcs: the x/y planes and the z planes); writes the fluid
    velsum, sum over fluid cells of |u| after their NEE rewrite, into
    series[slot] (float64). Only fluid cells are written: out must
    already hold f's non-fluid cells. On float32 state the launch takes a
    thread a lane of cc.fluid_launch (segments of the fluid cells' runs,
    lbm_collide_stream_list) when the case has a fluid-cell list
    (cc.fluid_cells), or a thread a cell of the box when that is None or
    with all_blocks; on bf16 state (the paired
    kernel) a thread an entry of cc.pair_launch: an interior pair of
    z-neighbour cells, or a cell (the interior pairs from the box, their
    bits in cc.pair_interior, when the case has no fluid-cell list or
    with all_blocks). field, g: the Boussinesq
    force field and the pre-step (7, X, Y, Z) scalar state it reads (the
    force-field instance). halo: None, or a shard's (axis, lo, hi,
    mask_lo, mask_hi) (K1d, lbm_collide_stream_halo). wk: the carried
    (n_wk,) float32 P_c of a case with windkessel outlets, stepped in
    place: the launch is the fold's (lbm_collide_stream_wk), which derives
    each outlet's rho* from P_c and the flux staged from f, writes the
    flux terms of out, and whose reduction commits P_c and stages out's
    flux (wk_stage). The flux kernel primes the stage first (windkessel
    _prime) when f is not the last fold launch's out, or with prime. On
    the CPU it runs the plain versions (step_wk_plain for the fold).
    Returns out."""
    _check_pair(f, out, cc, series, slot)
    name, ci, cf = collision_descriptor(cc, field)
    g_ptr = _check_field(field, g, cc, f)
    if halo is not None:
        _check_halo(halo, cc, f, field)
    if has_windkessel(cc.bcs):
        if halo is not None or field is not None:
            raise ValueError("windkessel outlets step whole boxes without a "
                             "force field")
        if all_blocks:
            raise ValueError("a case with windkessel outlets launches over "
                             "its fluid-cell list, the outlets' footprint "
                             "cells first (compile.fold_cell_ids)")
        _check_wk(wk, cc)
        stage = wk_stage(cc)
        if prime or stage.of != _state_key(f):
            windkessel_prime(f, cc)
        _collide_stream_wk(f, out, cc, series, slot, t, wk, stage, ci, cf,
                           f"{name}+wk")
        stage.of = _state_key(out)
        return out
    if wk is not None:
        raise ValueError("wk was given for a case without windkessel "
                         "outlets")
    if f.device.type == "cpu":
        f_new, vs = step_plain(f, cc, t, field, g, halo)
        out.copy_(f_new)
        series[slot] = vs
        return out
    nx, ny, nz = cc.shape
    n_cells = nx * ny * nz
    if n_cells >= 2**31:
        raise ValueError(f"{n_cells} cells: the kernel indexes cells in int32")
    route = launch_route(cc, f.dtype, all_blocks)
    if route == "lbm_collide_stream_list":
        _collide_stream_list(f, out, cc, series, slot, t, ci, cf, name,
                             g_ptr, halo, route)
        return out
    from lbm_tpu_torch.kernels._build import check

    lib = _library(f, halo)
    launch, tail, name = _entry(lib, name, f, g_ptr, halo)
    if _bf16(f):
        streamed, ids, n_inner = pair_launch(cc)
        box = streamed and (all_blocks or cc.fluid_cells is None)
        grid = _pair_grid(cc.shape, ids, n_inner, box, f, out)
        # the launch list, its pairs, the box's interior bits, the form
        listed = (ids.data_ptr(), ids.numel(), n_inner,
                  cc.pair_interior.data_ptr(), int(box))
    else:
        grid = max(1, -(-n_cells // lib.lbm_block_size()))
        listed = ()
    bcs = cc.step_bcs
    (ints, floats, valid, phis), partials = _launch_scratch(
        cc, "k1", bcs, t, grid)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = launch(
            f.data_ptr(), out.data_ptr(), cc.mask.data_ptr(),
            nx, ny, nz, ci.ctypes.data, cf.ctypes.data,
            len(bcs), ints.ctypes.data, floats.ctypes.data,
            ctypes.addressof(valid), ctypes.addressof(phis), *listed,
            partials.data_ptr(), grid, series.data_ptr(), slot, *tail,
            stream)
    check(lib, err, f"{route}[{name}]")
    _count(f"{route}[{name}]")
    return out


def launch_route(cc: CompiledCase, dtype=torch.float32,
                 all_blocks: bool = False) -> str:
    """The launch collide_stream makes for a step of cc on state of
    `dtype`, named as its launch counters begin: "lbm_collide_stream_list"
    for float32 state over the case's fluid cells (a case with a
    fluid-cell list, without windkessel outlets, not all_blocks:
    collide_stream_list_kernel over cc.fluid_launch), else
    "lbm_collide_stream" (the box, the paired bf16 kernel, the fold)."""
    listed = (dtype != torch.bfloat16 and not all_blocks
              and cc.fluid_cells is not None and not has_windkessel(cc.bcs))
    return "lbm_collide_stream_list" if listed else "lbm_collide_stream"


def counter_name(cc: CompiledCase, dtype=torch.float32,
                 field: ForceField | None = None, halo: bool = False,
                 all_blocks: bool = False) -> str:
    """The launch counter (`launches`) that collide_stream adds one to
    for a step of cc on state of `dtype`: launch_route's name and the
    instance (instance) with '+wk', '+halo' and '+bf16' as the launch
    has them."""
    wk = has_windkessel(cc.bcs)
    name = instance(cc, field) + ("+wk" if wk else "+halo" if halo else "")
    if dtype == torch.bfloat16:
        name += "+bf16"
    return f"{launch_route(cc, dtype, all_blocks)}[{name}]"


def _collide_stream_list(f, out, cc: CompiledCase, series, slot: int,
                         t: int, ci, cf, name: str, g_ptr, halo,
                         route: str) -> None:
    """collide_stream's launch of fp32 state over the case's fluid cells:
    one launch of lbm_collide_stream_list (a shard's: of
    lbm_collide_stream_halo_list) over cc.fluid_launch, and its
    reduction, counted under route (launch_route's name)."""
    from lbm_tpu_torch.kernels._build import check

    tables = cc.fluid_launch
    lib = _library(f, halo, listed=True)
    launch, tail, name = _entry(lib, name, f, g_ptr, halo, listed=True)
    n_segs = tables.segs.shape[0]
    grid = -(-n_segs * SEG // lib.lbm_list_block_size())
    nx, ny, nz = cc.shape
    bcs = cc.step_bcs
    (ints, floats, valid, phis), partials = _launch_scratch(
        cc, "k1", bcs, t, grid)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = launch(
            f.data_ptr(), out.data_ptr(), nx, ny, nz, ci.ctypes.data,
            cf.ctypes.data, len(bcs), ints.ctypes.data, floats.ctypes.data,
            ctypes.addressof(valid), ctypes.addressof(phis),
            tables.segs.data_ptr(), tables.links.data_ptr(),
            None if tables.moving is None else tables.moving.data_ptr(),
            n_segs, partials.data_ptr(), grid, series.data_ptr(), slot,
            *tail, stream)
    check(lib, err, f"{route}[{name}]")
    _count(f"{route}[{name}]")


def _collide_stream_wk(f, out, cc: CompiledCase, series, slot: int, t: int,
                       wk, stage: WKStage, ci, cf, name: str) -> None:
    """The fold's step of collide_stream: one launch of
    lbm_collide_stream_wk (its bf16 twin on bf16 state) and its
    reduction, or step_wk_plain on the CPU; P_c, the stage's terms and Q
    updated in place."""
    if f.device.type == "cpu":
        f_new, vs, p_new, terms, q = step_wk_plain(f, cc, t, wk, stage.q)
        out.copy_(f_new)
        series[slot] = vs
        wk.copy_(p_new)
        stage.terms.copy_(terms)
        stage.q.copy_(q)
        return
    from lbm_tpu_torch.kernels._build import check, load_wk_library

    lib = load_wk_library(_bf16(f)).lib
    name = _tagged(name, f)
    launch = (lib.lbm_collide_stream_wk_bf16 if _bf16(f)
              else lib.lbm_collide_stream_wk)
    nx, ny, nz = cc.shape
    if nx * ny * nz >= 2**31:
        raise ValueError(f"{nx * ny * nz} cells: the kernel indexes cells "
                         "in int32")
    ids, lists = cc.fluid_cells, wk_lists(cc)
    grid = max(1, -(-ids.numel() // lib.lbm_block_size()))
    bcs = cc.step_bcs
    (ints, floats, valid, phis), partials = _launch_scratch(
        cc, "k1", bcs, t, grid)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = launch(
            f.data_ptr(), out.data_ptr(), cc.mask.data_ptr(),
            nx, ny, nz, ci.ctypes.data, cf.ctypes.data,
            len(bcs), ints.ctypes.data, floats.ctypes.data,
            ctypes.addressof(valid), ctypes.addressof(phis),
            lists.bc_rows.ctypes.data, ids.data_ptr(), ids.numel(),
            partials.data_ptr(), grid, series.data_ptr(), slot,
            len(lists.rows), lists.rows.ctypes.data,
            lists.floats.ctypes.data, lists.weights.data_ptr(),
            lists.foot.data_ptr() if lists.foot.numel() else None,
            lists.foot.numel(), stage.terms.data_ptr(), stage.q.data_ptr(),
            wk.data_ptr(), stream)
    check(lib, err, f"lbm_collide_stream[{name}]")
    _count(f"lbm_collide_stream[{name}]")


def pair_launch(cc: CompiledCase) -> tuple[bool, torch.Tensor, int]:
    """(streamed, launch list, its pair count) of the paired bf16 kernel
    on the case: cc.pair_launch of its instance's form (streamed: BGK or
    TRT without a closure, which collide interior pairs at once) and the
    box's interior bits, built at first use (Simulation builds them with
    the case, so a run's first chunk does not)."""
    name = collision_descriptor(cc)[0]
    streamed = name.split("+")[0] in ("bgk", "trt") and cc.closure is None
    ids, n_inner = cc.pair_launch(streamed)
    _ = cc.pair_interior  # built here, read at launch
    return streamed, ids, n_inner


# The paired bf16 kernel's box form: a block of PAIR_LANES z pairs by
# PAIR_ROWS y rows (kPairLanes, kPairRows in csrc/collide_stream.cuh; the
# C entry refuses a partial count that does not match its grid).
PAIR_LANES, PAIR_ROWS = 32, 8


def _pair_grid(shape, ids, n_inner: int, box: bool, f, out) -> int:
    """The blocks of a bf16 step by the paired kernel over its launch list
    ids (cc.pair_launch: n_inner interior pairs, then cells), or with box
    over the box's interior pairs and the list's cells. Raises for a state
    the kernel does not take: its 2-byte populations are read and written
    as 4-byte words, and it indexes the state's elements in uint32."""
    nx, ny, nz = shape
    if 19 * nx * ny * nz >= 2**32:
        raise ValueError(f"{nx * ny * nz} cells: the bf16 kernel indexes the "
                         "state's 19 populations a cell in uint32")
    if nx > 65535:
        raise ValueError(f"nx = {nx}: the bf16 kernel's box grid takes x "
                         "rows on its third axis (at most 65535)")
    if f.data_ptr() % 4 or out.data_ptr() % 4:
        raise ValueError("the bf16 kernel reads and writes 4-byte words: f "
                         "and out must start 4-byte aligned")
    block = PAIR_LANES * PAIR_ROWS
    if not box:
        return max(1, -(-ids.numel() // block))
    n_pairs_z = -(-nz // 2)
    per_x = -(-n_pairs_z // PAIR_LANES) * -(-ny // PAIR_ROWS)
    return per_x * (nx + -(-(ids.numel() - n_inner) // (per_x * block)))


def _library(f, halo, listed: bool = False):
    """The library whose kernels step f: its storage type's (listed: the
    fp32 launch over the fluid cells'), or a shard's of its axis."""
    from lbm_tpu_torch.kernels._build import (
        load_halo_library,
        load_library,
        load_list_library,
    )

    if halo is not None:
        return load_halo_library(halo[0]).lib
    return (load_list_library() if listed else load_library(_bf16(f))).lib


def _entry(lib, name: str, f, g_ptr, halo, listed: bool = False):
    """(the collide-stream C entry for f's storage or a shard's halo, over
    the box or, listed, over the fluid cells, the arguments after the
    series slot but the stream, the counter's instance name)."""
    over = "_list" if listed else ""
    if halo is None:
        sfx = "_bf16" if _bf16(f) else ""
        return (getattr(lib, f"lbm_collide_stream{over}{sfx}"), (g_ptr,),
                _tagged(name, f))
    axis, lo, hi, mask_lo, mask_hi = halo
    return (getattr(lib, f"lbm_collide_stream_halo{over}"),
            (axis, lo.data_ptr(), hi.data_ptr(), mask_lo.data_ptr(),
             mask_hi.data_ptr()), f"{name}+halo")


# one whole step: the name the runner, the transports and the sharded step
# call it by
step = collide_stream


def div_exact_check(b: float, device) -> tuple[int, bool]:
    """(mismatches, reciprocal equal) of the paired bf16 kernel's division
    by b on the card: how many of the 2^32 fp32 dividends a give
    div_exact(a, b, __frcp_rn(b)) other bits than IEEE a / b (a NaN
    matching a NaN), and whether the host's 1.0f / b, the kernel's
    reciprocal of a launch divisor, equals __frcp_rn(b). Needs a card:
    the division exists on the device only."""
    from lbm_tpu_torch.kernels._build import check, load_library

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("div_exact_check runs on the card")
    lib = load_library(bf16=True).lib
    out = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = lib.lbm_div_exact_check(
            ctypes.c_float(b), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, "lbm_div_exact_check")
    bad, rcp = out.tolist()
    return int(bad), rcp == 0


def collide_stream2_plain(f, cc: CompiledCase, t: int):
    """The plain version of `step2`: two collide_stream_plain steps at
    absolute steps t and t + 1, (f'', velsum at t, velsum at t + 1) with
    the velsums float64 0-dim tensors and f'' in f's dtype. A bf16 f is
    widened, stepped twice in fp32 and narrowed once (the kernel's fp32
    mid tile), which two bf16 single steps are not."""
    f1, vs1 = collide_stream_plain(_widen(f), cc, t)
    f2, vs2 = collide_stream_plain(f1, cc, t + 1)
    return f2.to(f.dtype), vs1, vs2


def step2(f, out, cc: CompiledCase, series, slot: int, t: int,
          all_tiles: bool = False):
    """Two steps of f into out (a different buffer) at absolute steps t
    and t + 1, for a case whose NEE boundaries all lie on x/y planes
    (compile.fuse2_refusal; ValueError otherwise): series[slot] and
    series[slot + 1] get the two steps' fluid velsums. Only fluid cells
    are written: out must already hold f's non-fluid cells. The launch
    covers the case's live units (cc.live_tiles: x segments of (y, z)
    column tiles, TILE; every unit when that is None, or with
    all_tiles); the units left out hold only DEAD cells. Returns out."""
    _check_pair(f, out, cc, series, slot + 1)
    reason = fuse2_refusal(cc.spec)
    if reason is not None:
        raise ValueError(reason)
    name, ci, cf = collision_descriptor(cc)
    if f.device.type == "cpu":
        f2, vs1, vs2 = collide_stream2_plain(f, cc, t)
        out.copy_(f2)
        series[slot], series[slot + 1] = vs1, vs2
        return out
    from lbm_tpu_torch.kernels._build import check, load_pair_library

    lib = load_pair_library(_bf16(f)).lib
    name = _tagged(name, f)
    nx, ny, nz = cc.shape
    if nx * ny * nz >= 2**31:
        raise ValueError(f"{nx * ny * nz} cells: the kernel indexes cells "
                         "in int32")
    ids = None if all_tiles else cc.live_tiles
    unit = tuple(lib.lbm_pair_unit(a) for a in range(3))
    if unit != TILE:
        raise RuntimeError(f"the pair kernel's unit {unit} is not "
                           f"compile.TILE {TILE}")
    grid = (int(np.prod([-(-n // u) for n, u in zip(cc.shape, unit)]))
            if ids is None else ids.numel())
    bcs = cc.kernel_bcs
    (ints, floats, valid, phis), partials = _launch_scratch(
        cc, "k2", bcs, t, 2 * grid)
    (_, _, _, phis1), _ = _launch_scratch(cc, "k2 t+1", bcs, t + 1, 0)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        launch = lib.lbm_collide_stream2_bf16 if _bf16(f) \
            else lib.lbm_collide_stream2
        err = launch(
            f.data_ptr(), out.data_ptr(), cc.mask.data_ptr(),
            nx, ny, nz, ci.ctypes.data, cf.ctypes.data,
            len(bcs), ints.ctypes.data, floats.ctypes.data,
            ctypes.addressof(valid), ctypes.addressof(phis),
            ctypes.addressof(phis1),
            None if ids is None else ids.data_ptr(), grid,
            partials.data_ptr(), 2 * grid, series.data_ptr(), slot, stream)
    check(lib, err, f"lbm_collide_stream2[{name}]")
    _count(f"lbm_collide_stream2[{name}]")
    return out


def _check_whole(f) -> None:
    if f.dtype not in STORE_DTYPES or not f.is_contiguous() \
            or f.dim() != 4 or f.shape[0] != 19:
        raise ValueError("f must be a contiguous (19, X, Y, Z) float32 or "
                         "bfloat16 tensor")


def _check_rows(f, x0: int, wx: int) -> None:
    _check_whole(f)
    if not (0 <= x0 and 0 < wx and x0 + wx <= f.shape[1]):
        raise ValueError(f"rows [{x0}, {x0 + wx}) are not inside the "
                         f"{f.shape[1]} x rows")


def extract_rows_plain(f, x0: int, wx: int):
    """x rows [x0, x0 + wx) of a (19, X, Y, Z) state as a contiguous
    (19, wx, Y, Z) tensor."""
    return f[:, x0:x0 + wx].contiguous()


def extract_rows(f, x0: int, wx: int, out=None):
    """x rows [x0, x0 + wx) of a contiguous (19, X, Y, Z) float32 or
    bfloat16 state into out (a contiguous (19, wx, Y, Z) tensor of f's
    dtype on f's device, made when None). Returns out."""
    _check_rows(f, x0, wx)
    shape = (19, wx) + tuple(f.shape[2:])
    if out is None:
        out = torch.empty(shape, dtype=f.dtype, device=f.device)
    if out.dtype != f.dtype or not out.is_contiguous() \
            or tuple(out.shape) != shape or out.device != f.device:
        raise ValueError(f"out must be a contiguous {f.dtype} {shape} "
                         f"tensor on {f.device}")
    if f.device.type == "cpu":
        return out.copy_(extract_rows_plain(f, x0, wx))
    if f.device.type != "cuda":
        raise ValueError(f"no kernel for device {f.device}")
    from lbm_tpu_torch.kernels._build import check, load_pair_library

    lib = load_pair_library(_bf16(f)).lib
    name = "lbm_extract_rows[bf16]" if _bf16(f) else "lbm_extract_rows"
    launch = lib.lbm_extract_rows_bf16 if _bf16(f) else lib.lbm_extract_rows
    _, nx, ny, nz = f.shape
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = launch(f.data_ptr(), out.data_ptr(), nx, ny, nz, x0, wx,
                     stream)
    check(lib, err, name)
    _count(name)
    return out


# Bytes of one chunk of the chunked state read, as lbm_tpu's
# unpack_state_lowmem has them
CHUNK_BYTES = 256_000_000


def chunk_rows(shape) -> int:
    """x rows per chunk of unpack_state_lowmem for a (X, Y, Z) box: as
    many as fit CHUNK_BYTES at 4 bytes a population, at least one
    (lbm_tpu counts 4 bytes whatever the storage, so a bf16 chunk is half
    as large)."""
    _, ny, nz = shape
    return max(1, CHUNK_BYTES // (19 * ny * nz * 4))


def unpack_state_lowmem(f):
    """The state as a (19, X, Y, Z) float32 tensor in host memory, read in
    x-row chunks of at most CHUNK_BYTES (extract_rows into one device
    chunk, then a pinned staging buffer, both in the state's dtype), so
    device memory rises by one chunk, never by a second state (lbm_tpu's
    unpack_state_lowmem). A bf16 state crosses as bf16 and is widened on
    the host, as lbm_tpu's is."""
    _check_rows(f, 0, f.shape[1])
    _, nx, ny, nz = f.shape
    rows = chunk_rows((nx, ny, nz))
    out = torch.empty(tuple(f.shape), dtype=torch.float32)
    if f.device.type == "cpu":
        for x0 in range(0, nx, rows):
            w = min(rows, nx - x0)
            out[:, x0:x0 + w] = extract_rows(f, x0, w)
        return out
    n_max = 19 * rows * ny * nz
    dev = torch.empty(n_max, dtype=f.dtype, device=f.device)
    host = torch.empty(n_max, dtype=f.dtype, pin_memory=True)
    for x0 in range(0, nx, rows):
        w = min(rows, nx - x0)
        n = 19 * w * ny * nz
        chunk = extract_rows(f, x0, w, out=dev[:n].view(19, w, ny, nz))
        staged = host[:n].view(19, w, ny, nz)
        staged.copy_(chunk)  # waits for the stream: pinned, not async
        out[:, x0:x0 + w] = staged  # widens a bf16 chunk on the host
    return out


def macro(f, force=None):
    """(rho (X, Y, Z), u (3, X, Y, Z)) fp32 moments of every cell of a
    (19, X, Y, Z) float32 or bfloat16 state; with a body force (a
    3-vector) u = (m + F/2) / rho."""
    _check_whole(f)
    if force is not None and len(force) != 3:
        raise ValueError(f"force must be a 3-vector: {force!r}")
    if f.device.type == "cpu":
        return macro_plain(f, force)
    if f.device.type != "cuda":
        raise ValueError(f"no kernel for device {f.device}")
    from lbm_tpu_torch.kernels._build import check, load_library

    lib = load_library(_bf16(f)).lib
    rho = torch.empty(f.shape[1:], dtype=torch.float32, device=f.device)
    u = torch.empty((3,) + tuple(f.shape[1:]), dtype=torch.float32,
                    device=f.device)
    half = (None if force is None
            else np.asarray(half_force(force), np.float32))
    name = "lbm_macro" if force is None else "lbm_macro[force]"
    if _bf16(f):
        name = "lbm_macro[bf16]" if force is None else "lbm_macro[force+bf16]"
    launch = lib.lbm_macro_bf16 if _bf16(f) else lib.lbm_macro
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = launch(f.data_ptr(), rho.data_ptr(), u.data_ptr(),
                            rho.numel(),
                            None if half is None else half.ctypes.data,
                            stream)
    check(lib, err, name)
    _count(name)
    return rho, u


__all__ = ["collide_stream", "collide_stream_plain", "fix_z_plane_plain",
           "step", "step_plain", "step2", "windkessel_prime",
           "windkessel_flux_plain", "wk_terms_plain", "wk_commit_plain",
           "step_wk_plain", "wk_stage", "WKStage", "wk_lists", "WKLists",
           "WK_BLOCK",
           "collide_stream2_plain", "extract_rows", "extract_rows_plain",
           "unpack_state_lowmem", "chunk_rows", "CHUNK_BYTES",
           "live_block_ids", "macro", "macro_plain", "launches",
           "reset_launches", "instance", "collision_tables",
           "collision_descriptor", "CINT", "CFLOAT", "ForceField",
           "div_exact_check", "pair_launch", "PAIR_LANES", "PAIR_ROWS",
           "counter_name", "launch_route"]
