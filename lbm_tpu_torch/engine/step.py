"""The dense D3Q19 step in plain PyTorch: pull-stream + half-way
bounce-back (plain or moving walls, or Bouzidi curved walls) + NEE + collide (BGK, TRT, MRT or a
per-cell tau closure) + Guo body force over the whole lattice (torch
port of lbm_tpu/engine/step.py).

This is the CPU twin and the plain version the CUDA kernels are held
against (kernels/collide_stream.collide_stream_plain):

  for fluid cell x, direction i, neighbor n = x - e_i (wrapped on all axes):
    pulled_i(x) = f[i][n]                      if n is not a wall
                = f[opp(i)][x]                 if n is a wall (half-way BB)
                = f[opp(i)][x] + 6 w_i (e_i . u_w)
                                               if n is a MOVING wall (Ladd)
                = a f[opp(i)][x] + b_up f[opp(i)][x + e_i] + b_loc f[i][x]
                                               if n is a wall and the case
                                               has curved walls (Bouzidi;
                                               core/bouzidi.py)
                = rho* phi*_i + (f[i][x] - rho_prev phi_i(u_prev)) omega
                                               on an NEE consumer plane
  rho = sum pulled, u = (sum e_i pulled_i + F/2) / rho   (F/2: Guo force)
  f'(x) = collide(pulled, rho phi(u)) + Guo source

On a shard of a box split along one axis (engine/compile.ShardCase) the
pull across the shard's faces reads the planes its ring neighbours sent
(`halo`: the five populations with e_axis = +1 from the low neighbour's
last row, the five with e_axis = -1 from the high neighbour's first
row); every other source wraps as above (lbm_tpu's parallel/halo.py
_pull_ext), and the arithmetic is unchanged, so the shards of a box
stepped this way are the box's step bit for bit.

A windkessel (RCR) outlet's rewrite takes rho* = rho_fixed + 3 (Q Rp +
P_c') from its carried P_c (make_step_wk, pulled_state_wk): Q is the
outward flux of the pre-step consumer-plane velocity u_prev over the
outlet's footprint, and P_c steps by backward Euler (windkessel_update),
both in fp32 in lbm_tpu's operation order.

F is the constant CaseSpec.force or, through make_step_force, a per-cell
(3, X, Y, Z) field (the Boussinesq buoyancy of engine/thermal.py: e_i.F
and u.F per cell; the NEE rewrite keeps the constant force).
rho_prev/u_prev are the moments of the cell's own pre-step f (with the
same F/2 shift); phi* of a u_mode='series' boundary is its table at
phase (t // stride) % T, with t the absolute step. Non-fluid cells keep
their f.

The arithmetic is fp32 in a fixed operation order that the CUDA kernels
repeat: contractions over directions are signed sums in direction order,
constants are composed in double and rounded once as lbm_tpu composes
them, and every division is by a tensor (`_c`): PyTorch's CUDA division
by a Python scalar multiplies by the scalar's reciprocal instead. MRT's
19x19 products are written as sums too, so no TF32 path applies.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from lbm_tpu_torch.core.bouzidi import apply_links
from lbm_tpu_torch.core.lattice import D3Q19, _signed_sum, momentum, phi
from lbm_tpu_torch.core.rheology import pi_norm, tau_eff
from lbm_tpu_torch.engine.compile import (
    CompiledBC,
    CompiledCase,
    has_windkessel,
)

_E = D3Q19.E
_OPP = D3Q19.OPP
_OPP_IDX = [int(o) for o in _OPP]  # advanced index of the opposites
_F32 = np.float32


def _opposite(x):
    """x's 19 directions in opposite order, x[OPP] (a stack of x's
    unbound rows: no host index tensor, so a CUDA graph can capture it)."""
    rows = x.unbind(0)
    return torch.stack([rows[j] for j in _OPP_IDX])


def _c(value, like):
    """`value` as a 0-dim fp32 tensor on like's device: a divisor (or a
    dividend) that PyTorch divides by exactly, as the kernels do."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def pull_one(fi, e):
    """Pull-stream one direction: the value at x - e arrives at x.
    torch.roll wraps every axis, like jnp.roll."""
    shifts = [int(s) for s in e]
    dims = [a for a, s in enumerate(shifts) if s != 0]
    if not dims:
        return fi
    return torch.roll(fi, shifts=[shifts[a] for a in dims], dims=dims)


def is_force_field(force) -> bool:
    """True for a per-cell (3, X, Y, Z) force tensor (the Boussinesq
    buoyancy of engine/thermal.py), False for the constant 3-vector a
    CaseSpec carries."""
    return torch.is_tensor(force) and force.dim() > 1


def half_force(force):
    """The Guo half-force F/2 per component, in fp32: three floats of a
    constant force, three tensors of a force field."""
    if is_force_field(force):
        return tuple(0.5 * force[a] for a in range(3))
    return tuple(float(_F32(0.5) * _F32(c)) for c in force)


def velocity(rho, mom, force=None):
    """u = (m + F/2) / rho (the Guo velocity; F/2 only with a force, a
    constant 3-vector or a per-cell field), with rho == 0 read as 1. mom:
    the (mx, my, mz) tensors."""
    if force is not None:
        mom = tuple(m + h for m, h in zip(mom, half_force(force)))
    safe = torch.where(rho == 0, torch.ones_like(rho), rho)
    return torch.stack([m / safe for m in mom])


def moving_bb_terms(wall_velocity) -> np.ndarray:
    """(19,) f32 Ladd momentum terms of a translating no-slip wall:
    pulled_i gains 6 w_i rho_w (e_i . u_w) over plain bounce-back, rho_w
    = 1."""
    uw = np.asarray(wall_velocity, np.float64)
    e = _E.astype(np.float64)
    return (6.0 * D3Q19.W.astype(np.float64) * (e @ uw)).astype(np.float32)


def inbound_dirs(axis: int, sign: int) -> list[int]:
    """The five directions that stream across a face normal to `axis`:
    e_axis == sign, in direction order (lbm_tpu's parallel/halo.py)."""
    return [i for i in range(1, D3Q19.Q) if int(_E[i][axis]) == sign]


def halo_ext(f, axis: int, lo, hi):
    """A (19, ...) shard state with one ring row on each side of `axis`:
    row 0 holds lo, the (5, A, B) populations with e_axis = +1 at their
    directions, the last row hi, those with e_axis = -1; the ring's other
    populations are zeros (no pull reads them)."""
    ring = list(f.shape)
    ring[1 + axis] = 1
    rows = []
    for plane, sign in ((lo, 1), (hi, -1)):
        r = f.new_zeros(ring)
        r.select(1 + axis, 0)[inbound_dirs(axis, sign)] = plane.to(f.dtype)
        rows.append(r)
    return torch.cat([rows[0], f, rows[1]], dim=1 + axis)


def streamed(f, nbr_wall, nbr_moving=None, bb=None, halo=None,
             bouzidi=None):
    """Pull-stream all 19 directions with fused half-way bounce-back;
    MOVING sources (nbr_moving) add the Ladd term bb[i]. halo: None, or
    (axis, lo, hi) of a shard, whose sources beyond its rows on that axis
    are the planes'. bouzidi: None, or a case's links (CompiledCase.
    bouzidi), where the wall branch becomes a f[opp] + b_up up + b_loc
    f[i], up direction opp(i)'s own direct pull (lbm_tpu's order), applied
    to all links at once after the pull (core/bouzidi.apply_links)."""
    pulled = torch.stack(_streamed_list(f, nbr_wall, nbr_moving, bb, halo))
    if bouzidi is not None:
        apply_links(pulled, f, bouzidi)
    return pulled


def _streamed_list(f, nbr_wall, nbr_moving=None, bb=None, halo=None):
    """streamed's 19 pulled directions before the stack (no Bouzidi links),
    a list of (X, Y, Z) tensors; f is unbound once, so under autograd its
    19 reads are one backward node."""
    fs = f.unbind(0)
    if halo is None:
        def pull(i):
            return pull_one(fs[i], _E[i])
    else:
        axis, lo, hi = halo
        ext = halo_ext(f, axis, lo, hi).unbind(0)
        n = f.shape[1 + axis]

        def pull(i):
            return pull_one(ext[i], _E[i]).narrow(axis, 1, n)
    pulled = [fs[0]]
    for i in range(1, D3Q19.Q):
        v = torch.where(nbr_wall[i], fs[_OPP[i]], pull(i))
        if nbr_moving is not None:
            v = torch.where(nbr_moving[i], fs[_OPP[i]] + float(bb[i]), v)
        pulled.append(v)
    return pulled


def windkessel_update(p_c, q, wk):
    """One backward-Euler step (dt = 1 step) of the 3-element windkessel
    C dP_c/dt = Q - P_c / Rd, P_in = Q Rp + P_c: (P_c', P_in) as fp32
    0-dim tensors, in lbm_tpu's operation order, (P_c + Q / C) / (1 +
    1 / (Rd C)) with the denominator composed in fp32.

    wk: the (Rp, C, Rd) triple, either static numbers (folded into fp32
    constants, as lbm_tpu folds them at trace time) or a (3,) fp32 tensor,
    the differentiable route of engine/adjoint.py: the same operations on
    tensors, so gradients flow through the RCR values, and bit for bit
    the static route's values."""
    if torch.is_tensor(wk):
        rp, cap, rd = wk[0], wk[1], wk[2]
        one = torch.ones((), dtype=torch.float32, device=q.device)
        denom = one + one / (rd * cap)
        p_new = (p_c + q / cap) / denom
        return p_new, q * rp + p_new
    rp, cap, rd = (_F32(v) for v in wk)
    denom = _F32(1.0) + _F32(1.0) / (rd * cap)
    p_new = (p_c + q / _c(cap, q)) / _c(denom, q)
    return p_new, q * _c(rp, q) + p_new


def windkessel_rho(bc: CompiledBC, p_in):
    """The rewrite's rho* = rho_fixed + 3 P_in of a windkessel outlet."""
    return _c(_F32(bc.rho_fixed), p_in) + 3.0 * p_in


def windkessel_flux(u_axis, bc: CompiledBC):
    """The outward flux Q = flow_sign * sum(flow_weight * u[axis]) of a
    windkessel outlet over its (A, B) consumer plane (u_axis: u_prev's
    component along the boundary's axis there), masked where the weight
    is 0, as lbm_tpu masks it (fp32; the sum in torch's order)."""
    w = bc.flow_weight
    terms = torch.where(w != 0, w * u_axis, torch.zeros_like(u_axis))
    return float(_F32(bc.flow_sign)) * terms.sum()


def apply_bc_fixup(pulled, f_src, bc: CompiledBC, t: int, force=None,
                   wk_p=None, rho_star=None):
    """Overwrite the pulled populations on one NEE boundary's consumer
    plane, in place, at absolute step t. pulled: the (19, X, Y, Z) tensor
    or a list of its 19 directions (pulled_state's, whose directions are
    tensors of their own: a write into one is one direction's under
    autograd, not the whole state's). Reads the pre-step f_src of the
    plane's own cells; u_prev carries the same F/2 shift as the
    collide's u.

    A windkessel outlet (bc.windkessel set) takes its rho* from the
    device: either `rho_star` (a 0-dim fp32 tensor, the flux kernel's or
    its plain version's), or from its carried P_c `wk_p`, the outward
    flux Q of this plane's u_prev and windkessel_update; with wk_p the
    call returns (pulled, P_c')."""
    src_pl = f_src.select(bc.axis + 1, bc.consumer_coord)   # (19, A, B)
    rho_prev, mom = momentum(src_pl)
    u_prev = velocity(rho_prev, mom, force)
    phi_nbr = phi(u_prev, dirs=bc.dirs)                      # (D, A, B)
    feq_nbr = rho_prev[None] * phi_nbr
    phi_star = (phi_nbr if bc.u_mode == "extrapolate"
                else bc.phi_star_at(t))
    p_new = None
    if bc.windkessel is not None:
        if wk_p is not None:
            q = windkessel_flux(u_prev[bc.axis], bc)
            p_new, p_in = windkessel_update(wk_p, q, bc.windkessel)
            rho_star = windkessel_rho(bc, p_in)
        elif rho_star is None:
            raise ValueError("a windkessel outlet needs its carried P_c "
                             "(make_step_wk / pulled_state_wk) or its rho*")
    elif bc.rho_fixed is None:
        rho_star = rho_prev[None]
    else:
        rho_star = bc.rho_fixed
    src_rows = src_pl.unbind(0)
    src_dirs = torch.stack([src_rows[i] for i in bc.dirs])
    val = rho_star * phi_star + (src_dirs - feq_nbr) * bc.omega
    for d, i in enumerate(bc.dirs):
        plane = pulled[i].select(bc.axis, bc.consumer_coord)
        plane.copy_(torch.where(bc.valid[d], val[d], plane))
    return pulled if wk_p is None else (pulled, p_new)


def halo_mask_ext(mask, axis: int, mask_lo, mask_hi):
    """A shard's (X, Y, Z) labels with its neighbours' (A, B) rows
    mask_lo and mask_hi as ring rows on `axis`."""
    return torch.cat([mask_lo.unsqueeze(axis), mask,
                      mask_hi.unsqueeze(axis)], dim=axis)


def _streamed_case(cc: CompiledCase, f, halo=None):
    """The case's pull: the stacked (19, X, Y, Z) tensor with Bouzidi links,
    else the list of 19 directions (the plane rewrites then write into
    each direction's own tensor, and pulled_state stacks them last)."""
    bb = (None if cc.wall_velocity is None
          else moving_bb_terms(cc.wall_velocity))
    halo = None if halo is None else halo[:3]
    if cc.bouzidi is not None:
        return streamed(f, cc.nbr_wall, cc.nbr_moving, bb, halo, cc.bouzidi)
    return _streamed_list(f, cc.nbr_wall, cc.nbr_moving, bb, halo)


def pulled_state(cc: CompiledCase, f, t: int, bcs=None, halo=None,
                 rho_wk=None):
    """The pre-collision state at step t: pull-stream with bounce-back
    and moving walls plus the NEE fixups of `bcs` (default every
    boundary), in order. halo: None, or a shard's (axis, lo, hi, ...)
    (ShardCase.halo), the planes its neighbours sent; the shard's
    neighbour tables (ShardCase.nbr_wall) already hold their rows'
    labels. rho_wk: the (n_wk,) rho* of the windkessel outlets this step
    (the flux kernel's); a case with windkessel outlets otherwise steps
    through pulled_state_wk."""
    pulled = _streamed_case(cc, f, halo)
    for bc in cc.bcs if bcs is None else bcs:
        rho = None
        if bc.windkessel is not None:
            if rho_wk is None:
                raise ValueError("the case has windkessel outlets; use "
                                 "pulled_state_wk with the carried state")
            rho = rho_wk[bc.wk_index]
        pulled = apply_bc_fixup(pulled, f, bc, t, cc.force, rho_star=rho)
    return pulled if torch.is_tensor(pulled) else torch.stack(pulled)


def windkessel_fluxes(cc: CompiledCase, f):
    """(n_wk,) fp32: each windkessel outlet's outward flux Q over its
    consumer plane of the pre-step state f (its u_prev, with the F/2
    shift of cc.force), in wk_index order. On a shard: the sum over its
    rows of the footprint."""
    qs = []
    for bc in cc.bcs:
        if bc.windkessel is not None:
            rho_prev, mom = momentum(f.select(bc.axis + 1,
                                              bc.consumer_coord))
            u_prev = velocity(rho_prev, mom, cc.force)
            qs.append(windkessel_flux(u_prev[bc.axis], bc))
    return torch.stack(qs)


def pulled_state_wk(cc: CompiledCase, f, t: int, wk, halo=None,
                    reduce=None, theta=None):
    """pulled_state of a case with windkessel outlets: wk is the (n_wk,)
    fp32 carried P_c (compile.wk_init's order); returns (pulled, wk')
    with every boundary applied in boundary order, as lbm_tpu's (each
    outlet's rho* from its Q of the pre-step state). halo: a shard's, as
    in pulled_state; reduce: what turns the (n_wk,) flux partials into
    the whole footprints' sums (a mesh's add_in_rank_order). theta: None,
    or an (n_wk, 3) fp32 tensor of (Rp, C, Rd) rows in place of the
    boundaries' static triples (engine/adjoint.py's differentiable
    route)."""
    q = windkessel_fluxes(cc, f)
    if reduce is not None:
        q = reduce(q)
    rho, wk_new = [], []
    for bc in cc.bcs:
        if bc.windkessel is not None:
            k = bc.wk_index
            p_new, p_in = windkessel_update(
                wk[k], q[k], bc.windkessel if theta is None else theta[k])
            rho.append(windkessel_rho(bc, p_in))
            wk_new.append(p_new)
    return (pulled_state(cc, f, t, halo=halo, rho_wk=torch.stack(rho)),
            torch.stack(wk_new))


def _matvec(mat: np.ndarray, vecs):
    """rows of (mat @ vecs) for a constant (19, 19) fp32 matrix and 19
    tensors: each a sum over the nonzero entries in column order."""
    out = []
    for i in range(mat.shape[0]):
        acc = None
        for j in range(mat.shape[1]):
            c = float(mat[i, j])
            if c == 0.0:
                continue
            term = c * vecs[j]
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else torch.zeros_like(vecs[0]))
    return torch.stack(out)


def les_tau_eff(fneq, rho, tau: float, cs: float):
    """Smagorinsky's per-cell tau_eff: closure ('smag', cs) of
    core/rheology.tau_eff (lbm_tpu's back-compat wrapper)."""
    return tau_eff(fneq, rho, tau, ("smag", float(cs)))


def closure_tau_minus(te, tau: float, tau_minus: float):
    """Per-cell odd rate of TRT + a closure: the magic parameter Lambda =
    (tau+ - 1/2)(tau- - 1/2) held at its static value while the closure
    varies the even rate."""
    lam = _F32((float(tau) - 0.5) * (float(tau_minus) - 0.5))
    return 0.5 + _c(lam, te) / (te - 0.5)


def collide(pulled, f_eq, tau: float, tau_minus: Optional[float] = None,
            mrt_k: Optional[np.ndarray] = None):
    """Post-collision populations with a constant rate (no force; the
    per-cell closures are post_collision's).

    BGK: f - (f - feq) / tau. TRT: f - s/(2 tau) - d/(2 tau_minus) with
    s = (f + f_o) - (feq + feq_o), d = (f - f_o) - (feq - feq_o), o the
    opposite direction. MRT: f - K (f - feq)."""
    if mrt_k is not None:
        return pulled - _matvec(mrt_k, pulled - f_eq)
    if tau_minus is None:
        return pulled - (pulled - f_eq) / _c(_F32(tau), pulled)
    p_o, e_o = _opposite(pulled), _opposite(f_eq)
    s = (pulled + p_o) - (f_eq + e_o)
    d = (pulled - p_o) - (f_eq - e_o)
    return (pulled - s / _c(2 * _F32(tau), pulled)
            - d / _c(_F32(2.0 * tau_minus), pulled))


def guo_rates(tau: float, tau_minus: Optional[float] = None):
    """(cp, cm) fp32 Guo prefactors of the even and odd halves: cp = 1 -
    1/(2 tau), cm = 1 - 1/(2 tau_minus) (cm = cp without TRT)."""
    cp = _F32(1.0 - 0.5 / tau)
    return cp, cp if tau_minus is None else _F32(1.0 - 0.5 / tau_minus)


def guo_constants(force, tau: float, tau_minus: Optional[float] = None):
    """Per-direction fp32 constants of the constant-force Guo source:
    (eF_i = e_i . F, cm g_odd_i = cm (3 w_i) eF_i, cp, cm) with cp = 1 -
    1/(2 tau), cm = 1 - 1/(2 tau_minus) (cm = cp without TRT). The CUDA
    kernels take the same values."""
    fv = np.asarray(force, np.float32)
    e_f = _E.astype(np.float32) @ fv
    cp, cm = guo_rates(tau, tau_minus)
    g_odd = (_F32(3.0) * D3Q19.W) * e_f
    return e_f, (cm * g_odd).astype(np.float32), cp, cm


def guo_parts(u, force):
    """The raw Guo source split by parity, per direction: g_even_i =
    w_i (9 (e_i.u)(e_i.F) - 3 u.F) (tensors) and g_odd_i = 3 w_i e_i.F
    (fp32 constants of a constant force; tensors of a force field, whose
    e_i.F is the signed sum of its components in x, y, z order)."""
    w3 = _F32(3.0) * D3Q19.W
    if is_force_field(force):
        zero = torch.zeros_like(u[0])
        e_f = [_signed_sum(force, _E[i]) for i in range(D3Q19.Q)]
        e_f = [zero if v is None else v for v in e_f]
        u_f = u[0] * force[0] + u[1] * force[1] + u[2] * force[2]
        odd = [float(w3[i]) * e_f[i] for i in range(D3Q19.Q)]
    else:
        fv = np.asarray(force, np.float32)
        e_f = [float(v) for v in _E.astype(np.float32) @ fv]
        u_f = u[0] * float(fv[0]) + u[1] * float(fv[1]) + u[2] * float(fv[2])
        odd = w3 * (_E.astype(np.float32) @ fv)
    even = []
    for i in range(D3Q19.Q):
        eu = _signed_sum(u, _E[i])
        if eu is None:
            eu = torch.zeros_like(u_f)
        even.append(float(D3Q19.W[i]) * (9.0 * eu * e_f[i] - 3.0 * u_f))
    return even, odd


def guo_source(u, force, tau: float, tau_minus: Optional[float] = None,
               mrt_kf: Optional[np.ndarray] = None, tau_local=None,
               tau_local_minus=None):
    """(19, ...) Guo forcing source. Each parity half carries (1 -
    rate/2) of its own relaxation rate: cp g_even + cm g_odd for BGK/TRT,
    KF (g_even + g_odd) for MRT, and for a closure the per-cell
    (1 - 1/(2 tau_eff)) on both halves (TRT + closure: the odd half at
    tau_local_minus)."""
    even, odd = guo_parts(u, force)
    field = is_force_field(force)
    if not field:
        odd = [float(o) for o in odd]
    if mrt_kf is not None:
        return _matvec(mrt_kf, [g + o for g, o in zip(even, odd)])
    if tau_local is not None:
        cp = 1.0 - _c(0.5, u) / tau_local
        if tau_local_minus is not None:
            cm = 1.0 - _c(0.5, u) / tau_local_minus
            return torch.stack([cp * g + cm * o for g, o in zip(even, odd)])
        return torch.stack([cp * (g + o) for g, o in zip(even, odd)])
    if field:
        cp, cm = guo_rates(tau, tau_minus)
        return torch.stack([float(cp) * g + float(cm) * o
                            for g, o in zip(even, odd)])
    _, cm_odd, cp, _ = guo_constants(force, tau, tau_minus)
    return torch.stack([float(cp) * g + float(c)
                        for g, c in zip(even, cm_odd)])


_UNSET = object()


def post_collision(cc: CompiledCase, pulled, f_eq, rho, u, force=_UNSET):
    """Collide + Guo source of one compiled case (no fluid select). A
    closure computes tau_eff once for the relax and the source. `force`
    takes the place of cc.force when given (a per-cell field)."""
    if force is _UNSET:
        force = cc.force
    if cc.closure is not None:
        fneq = pulled - f_eq
        te = tau_eff(fneq, rho, cc.tau, cc.closure)
        te_m = None
        if cc.tau_minus is None:
            f_post = pulled - fneq / te[None]
        else:
            te_m = closure_tau_minus(te, cc.tau, cc.tau_minus)
            fneq_o = _opposite(fneq)
            s = fneq + fneq_o
            d = fneq - fneq_o
            f_post = pulled - s / (2.0 * te[None]) - d / (2.0 * te_m[None])
        if force is not None:
            f_post = f_post + guo_source(u, force, cc.tau, tau_local=te,
                                         tau_local_minus=te_m)
        return f_post
    f_post = collide(pulled, f_eq, cc.tau, cc.tau_minus, cc.mrt_k)
    if force is not None:
        f_post = f_post + guo_source(u, force, cc.tau, cc.tau_minus,
                                     cc.mrt_kf)
    return f_post


def collide_cells(cc: CompiledCase, pulled, force=_UNSET):
    """Moments (with the F/2 shift) + collide + source of pulled
    populations: (f_post, rho, u), every cell. `force` takes the place
    of cc.force when given."""
    if force is _UNSET:
        force = cc.force
    rho, mom = momentum(pulled)
    u = velocity(rho, mom, force)
    f_eq = rho[None] * phi(u)
    return post_collision(cc, pulled, f_eq, rho, u, force), rho, u


def step_tail(cc: CompiledCase, f, pulled, force=_UNSET):
    """Moments + collide + fluid select. Returns (f', rho, u). `force`
    takes the place of cc.force when given (make_step_force)."""
    f_post, rho, u = collide_cells(cc, pulled, force)
    return torch.where(cc.fluid[None], f_post, f), rho, u


def make_step(cc: CompiledCase) -> Callable:
    """The dense step: (f, t) -> (f', rho, u), t the absolute step (it
    sets the phase of series boundaries). rho/u are this step's moments,
    valid at fluid cells (macro_fields gives the persistent fields). A
    case with windkessel outlets steps with make_step_wk."""
    if has_windkessel(cc.bcs):
        raise ValueError("the case has windkessel outlets; build the step "
                         "with make_step_wk")

    def step(f, t):
        return step_tail(cc, f, pulled_state(cc, f, t))

    return step


def make_first_step(cc: CompiledCase) -> Callable:
    """The reference's literal FIRST step: every neighbour slot, wall and
    NEE boundary alike, still holds its initial feq (the reference's
    boundary pass has not run yet when its first update reads the freshly
    initialized state), so fluid cells pull every direction directly:
    plain rolls, no bounce-back or NEE rewrite. It differs from make_step
    only where an initial velocity at a wall or boundary cell disagrees
    with what the fused rewrites reproduce (Poiseuille's rim wall cells,
    whose initial state carries the parabola); from step 2 on make_step
    is exact. Opt-in, for strict transient parity."""

    def first_step(f, t):
        pulled = torch.stack([f[0]] + [pull_one(f[i], _E[i])
                                        for i in range(1, D3Q19.Q)])
        return step_tail(cc, f, pulled)

    return first_step


def make_step_wk(cc: CompiledCase) -> Callable:
    """The dense step of a case with windkessel (RCR) outlets: (f, t,
    wk) -> (f', rho, u, wk') with wk the (n_wk,) fp32 carried P_c
    (compile.wk_init)."""

    def step(f, t, wk):
        pulled, wk_new = pulled_state_wk(cc, f, t, wk)
        f_new, rho, u = step_tail(cc, f, pulled)
        return f_new, rho, u, wk_new

    return step


def boussinesq_force(g, fluid, buoyancy, c_ref: float, base=None):
    """(3, X, Y, Z) Boussinesq force field of a (7, X, Y, Z) scalar
    state: F = buoyancy (c - c_ref) at fluid cells and 0 elsewhere, plus
    the constant `base` everywhere when given; c the sum of g's seven
    channels in order. buoyancy, c_ref and base are rounded to fp32
    first, as the kernels take them."""
    c = g[0]
    for i in range(1, g.shape[0]):
        c = c + g[i]
    dc = torch.where(fluid, c - float(_F32(c_ref)), torch.zeros_like(c))
    comps = [float(_F32(b)) * dc for b in buoyancy]
    if base is not None:
        comps = [f + float(_F32(b)) for f, b in zip(comps, base)]
    return torch.stack(comps)


def make_step_force(cc: CompiledCase) -> Callable:
    """The dense step with a runtime force: (f, t, force) -> (f', rho,
    u), force a per-cell (3, X, Y, Z) tensor (or a constant 3-vector)
    applied with the same Guo scheme as CaseSpec.force: the half shift
    of u, the parity-split source with e_i.F and u.F per cell. The
    plane-boundary NEE rewrites keep the static cc.force in their
    previous-moment half shift, as lbm_tpu's make_step_force does (closed
    thermal boxes have no plane boundary)."""
    if has_windkessel(cc.bcs):
        raise ValueError("windkessel outlets are not wired for the "
                         "runtime-force step")

    def step(f, t, force):
        return step_tail(cc, f, pulled_state(cc, f, t), force)

    return step


def tau_eff_field(cc: CompiledCase, f, t: int, wk=None):
    """(X, Y, Z) per-cell tau_eff of the closure over step t's
    pre-collision state (meaningful at fluid cells); wk: the carried P_c
    of a case with windkessel outlets."""
    if cc.closure is None:
        raise ValueError("the case has no tau closure")
    pulled = (pulled_state_wk(cc, f, t, wk)[0] if wk is not None
              else pulled_state(cc, f, t))
    rho, mom = momentum(pulled)
    u = velocity(rho, mom, cc.force)
    return tau_eff(pulled - rho[None] * phi(u), rho, cc.tau, cc.closure)


def fluid_speed_sum(cc: CompiledCase, u):
    """sum over fluid cells of |u|, in float64 (the velsum sample, without
    the non-fluid offset)."""
    speed = torch.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
    return torch.where(cc.fluid, speed, torch.zeros_like(speed)).sum(
        dtype=torch.float64)


def initial_f(cc: CompiledCase):
    """f(0) = feq(rho0, u0) everywhere."""
    return (cc.rho0[None] * phi(cc.u0)).contiguous()


def macro_fields(cc: CompiledCase, f):
    """The persistent macroscopic fields: moments (u with the F/2 shift)
    at fluid cells, the init (rho0, u0) elsewhere."""
    rho, mom = momentum(f)
    return init_override(cc, rho, velocity(rho, mom, cc.force))


def init_override(cc: CompiledCase, rho, u):
    """Replace non-fluid cells' moments with their init values."""
    return (torch.where(cc.fluid, rho, cc.rho0),
            torch.where(cc.fluid[None], u, cc.u0))


__all__ = ["make_step", "make_first_step", "make_step_wk", "make_step_force",
           "pulled_state_wk", "windkessel_update", "windkessel_flux",
           "windkessel_fluxes",
           "windkessel_rho", "boussinesq_force", "is_force_field", "guo_rates",
           "initial_f", "macro_fields", "init_override",
           "streamed", "pull_one", "inbound_dirs", "halo_ext",
           "halo_mask_ext", "collide",
           "collide_cells",
           "apply_bc_fixup", "pulled_state", "post_collision", "step_tail",
           "fluid_speed_sum", "guo_source", "guo_constants", "half_force",
           "velocity", "moving_bb_terms", "closure_tau_minus", "tau_eff",
           "les_tau_eff",
           "tau_eff_field", "pi_norm"]
