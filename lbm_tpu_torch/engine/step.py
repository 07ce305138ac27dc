"""The dense D3Q19 step in plain PyTorch: pull-stream + half-way
bounce-back + NEE + BGK collide over the whole lattice (torch port of
the BGK parts of lbm_tpu/engine/step.py).

This is the CPU twin and the plain version the CUDA kernel is held
against (kernels/collide_stream.collide_stream_plain):

  for fluid cell x, direction i, neighbor n = x - e_i (wrapped on all axes):
    pulled_i(x) = f[i][n]                      if n is not a wall
                = f[opp(i)][x]                 if n is a wall (half-way BB)
                = rho* phi*_i + (f[i][x] - rho_prev phi_i(u_prev)) omega
                                               on an NEE consumer plane
  rho, u = moments(pulled); f'(x) = pulled - (pulled - feq(rho, u)) / tau

rho_prev/u_prev are the moments of the cell's own pre-step f; phi* of a
u_mode='series' boundary is its table at phase (t // stride) % T, with t
the absolute step. Non-fluid cells keep their f. Boundaries on x, y and
z planes all go through `apply_bc_fixup`, in boundary order.
"""

from __future__ import annotations

from typing import Callable

import torch

from lbm_tpu_torch.core.lattice import D3Q19, momentum, phi
from lbm_tpu_torch.engine.compile import CompiledBC, CompiledCase

_E = D3Q19.E
_OPP = D3Q19.OPP


def pull_one(fi, e):
    """Pull-stream one direction: the value at x - e arrives at x.
    torch.roll wraps every axis, like jnp.roll."""
    shifts = [int(s) for s in e]
    dims = [a for a, s in enumerate(shifts) if s != 0]
    if not dims:
        return fi
    return torch.roll(fi, shifts=[shifts[a] for a in dims], dims=dims)


def _safe_velocity(rho, mom):
    safe = torch.where(rho == 0, torch.ones_like(rho), rho)
    return torch.stack([m / safe for m in mom])


def streamed(f, nbr_wall):
    """Pull-stream all 19 directions with fused half-way bounce-back."""
    pulled = [f[0]]
    for i in range(1, D3Q19.Q):
        direct = pull_one(f[i], _E[i])
        pulled.append(torch.where(nbr_wall[i], f[_OPP[i]], direct))
    return torch.stack(pulled)


def apply_bc_fixup(pulled, f_src, bc: CompiledBC, t: int):
    """Overwrite the pulled populations on one NEE boundary's consumer
    plane, in place, at absolute step t. Reads the pre-step f_src of the
    plane's own cells."""
    src_pl = f_src.select(bc.axis + 1, bc.consumer_coord)   # (19, A, B)
    rho_prev, mom = momentum(src_pl)
    u_prev = _safe_velocity(rho_prev, mom)
    phi_nbr = phi(u_prev, dirs=bc.dirs)                      # (D, A, B)
    feq_nbr = rho_prev[None] * phi_nbr
    phi_star = (phi_nbr if bc.u_mode == "extrapolate"
                else bc.phi_star_at(t))
    rho_star = rho_prev[None] if bc.rho_fixed is None else bc.rho_fixed
    src_dirs = src_pl[list(bc.dirs)]
    val = rho_star * phi_star + (src_dirs - feq_nbr) * bc.omega
    for d, i in enumerate(bc.dirs):
        plane = pulled[i].select(bc.axis, bc.consumer_coord)
        plane.copy_(torch.where(bc.valid[d], val[d], plane))
    return pulled


def pulled_state(cc: CompiledCase, f, t: int, bcs=None):
    """The pre-collision state at step t: pull-stream with bounce-back
    plus the NEE fixups of `bcs` (default every boundary), in order."""
    pulled = streamed(f, cc.nbr_wall)
    for bc in cc.bcs if bcs is None else bcs:
        pulled = apply_bc_fixup(pulled, f, bc, t)
    return pulled


def collide(pulled, f_eq, tau: float):
    """BGK, dividing by tau like the reference (ldc.cu:350-368) rather than
    multiplying by a rounded 1/tau. tau goes in as a 0-dim tensor on the
    state's device: PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal instead."""
    tau_t = torch.full((), tau, dtype=pulled.dtype, device=pulled.device)
    return pulled - (pulled - f_eq) / tau_t


def step_tail(cc: CompiledCase, f, pulled):
    """Moments + collide + fluid select. Returns (f', rho, u)."""
    rho, mom = momentum(pulled)
    u = _safe_velocity(rho, mom)
    f_eq = rho[None] * phi(u)
    f_post = collide(pulled, f_eq, cc.tau)
    f_new = torch.where(cc.fluid[None], f_post, f)
    return f_new, rho, u


def make_step(cc: CompiledCase) -> Callable:
    """The dense step: (f, t) -> (f', rho, u), t the absolute step (it
    sets the phase of series boundaries). rho/u are this step's moments,
    valid at fluid cells (macro_fields gives the persistent fields)."""

    def step(f, t):
        return step_tail(cc, f, pulled_state(cc, f, t))

    return step


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
    """The persistent macroscopic fields: moments at fluid cells, the init
    (rho0, u0) elsewhere."""
    rho, mom = momentum(f)
    u = _safe_velocity(rho, mom)
    return init_override(cc, rho, u)


def init_override(cc: CompiledCase, rho, u):
    """Replace non-fluid cells' moments with their init values."""
    return (torch.where(cc.fluid, rho, cc.rho0),
            torch.where(cc.fluid[None], u, cc.u0))


__all__ = ["make_step", "initial_f", "macro_fields", "init_override",
           "streamed", "pull_one", "collide", "apply_bc_fixup",
           "pulled_state", "step_tail", "fluid_speed_sum"]
