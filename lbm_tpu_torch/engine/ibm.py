"""Immersed boundary method (IBM): moving no-slip surfaces represented by
Lagrangian markers exerting a direct-forcing body force on the flow (torch
port of lbm_tpu/engine/ibm.py).

Scheme (explicit diffuse-interface direct forcing, the IB-LBM of Wu & Shu
and the multi-direct forcing of Wang et al.), per step, from the
pre-collision pulled state:

    u*(x)     = (sum_i e_i pulled_i + F_base/2) / rho      (engine/step)
    U*(X_m)   = sum_x u*(x) d4(x - X_m)                    (interp)
    F_m       = 2 rho_m (U_b(X_m) - U*(X_m)) s_m           (forcing)
    F(x)      = sum_m F_m d4(x - X_m)                      (spread)
    collide with the Guo source at force F                 (step_tail)

d4 is Peskin's 4-point discrete delta (support 4^3 = 64 cells, exact on
constants and linears); s_m the marker's surface measure. n_iter > 1
repeats the forcing on u* + F/(2 rho) and accumulates the correction (the
multi-direct forcing: each sweep tightens the no-slip defect).

The grid force enters through the dense step's per-cell Guo source
(step.make_step_force's route), so IBM takes every collision operator
that route takes but MRT. These are torch ops on the case's device: lbm_tpu
steps IBM through its XLA dense step, with no Pallas kernel. `spread` is a
scatter-add (index_add_), which adds in index order on the CPU and in no
fixed order on CUDA.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import momentum
from lbm_tpu_torch.engine.compile import CompiledCase, compile_case
from lbm_tpu_torch.engine.graph import StepGraph, graphable
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.engine.step import (
    initial_f,
    macro_fields,
    pulled_state,
    step_tail,
    velocity,
)


def _phi4(r):
    """Peskin's 4-point delta phi(r), support |r| < 2 (elementwise)."""
    a = torch.abs(r)
    inner = (3.0 - 2.0 * a + torch.sqrt(torch.clamp(
        1.0 + 4.0 * a - 4.0 * a * a, min=0.0))) / 8.0
    outer = (5.0 - 2.0 * a - torch.sqrt(torch.clamp(
        -7.0 + 12.0 * a - 4.0 * a * a, min=0.0))) / 8.0
    zero = torch.zeros_like(a)
    return torch.where(a <= 1.0, inner, torch.where(a < 2.0, outer, zero))


def _support(Xm, shape):
    """(M, 64) flat cell indices (int64) and (M, 64) tensor-product weights
    of the 4^3 stencil around each marker, wrapped periodically like the
    step's pull (torch.remainder: a floored modulo, as jnp.mod, so the
    negative indices of markers near 0 wrap to the far side)."""
    nx, ny, nz = (int(s) for s in shape)
    i0 = torch.floor(Xm).to(torch.int64) - 1                    # (M, 3)
    offs = torch.arange(4, dtype=torch.int64, device=Xm.device)
    idx = i0[:, :, None] + offs[None, None, :]                  # (M, 3, 4)
    w = _phi4(Xm[:, :, None] - idx.to(torch.float32))           # (M, 3, 4)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    weights = (wx[:, :, None, None] * wy[:, None, :, None]
               * wz[:, None, None, :]).reshape(-1, 64)
    ix = torch.remainder(idx[:, 0], nx)
    iy = torch.remainder(idx[:, 1], ny)
    iz = torch.remainder(idx[:, 2], nz)
    flat = (ix[:, :, None, None] * (ny * nz) + iy[:, None, :, None] * nz
            + iz[:, None, None, :]).reshape(-1, 64)
    return flat, weights


def interp(field, flat, weights):
    """Interpolate a (C, X, Y, Z) field at the markers -> (M, C)."""
    vals = field.reshape(field.shape[0], -1)[:, flat]           # (C, M, 64)
    return torch.sum(vals * weights[None], dim=-1).T


def spread(Fm, flat, weights, shape):
    """Spread (M, 3) marker forces -> the (3, X, Y, Z) grid force (a
    scatter-add over the markers' stencils)."""
    contrib = Fm[:, :, None] * weights[:, None, :]              # (M, 3, 64)
    out = torch.zeros((3, int(np.prod(shape))), dtype=torch.float32,
                      device=Fm.device)
    out.index_add_(1, flat.reshape(-1),
                   contrib.transpose(0, 1).reshape(3, -1))
    return out.reshape((3,) + tuple(int(s) for s in shape))


def half_force_base(F_grid, base):
    """Grid force + the case's static base force (a 3-vector rounded to
    fp32, or a (3,) fp32 tensor on F_grid's device)."""
    if not torch.is_tensor(base):
        base = torch.from_numpy(np.asarray(base, np.float32)).to(
            F_grid.device)
    return F_grid + base.reshape(3, 1, 1, 1)


def make_ibm_step(cc: CompiledCase, s_m=1.0, n_iter: int = 2) -> Callable:
    """(f, t, Xm, Ub) -> (f', rho, u, F_grid): one dense LBM step with the
    IBM direct-forcing body force computed from the live pulled state. Xm
    (M, 3) marker positions, Ub (M, 3) prescribed marker velocities, fp32
    tensors on the case's device. s_m: a scalar or (M,) marker surface
    measure. n_iter: multi-direct-forcing sweeps."""
    if cc.mrt_k is not None:
        raise ValueError(
            "IBM's per-cell force needs the Guo source; MRT + field force "
            "is not wired (same constraint as the buoyant route)")
    shape = tuple(int(v) for v in cc.shape)
    s_col = (torch.full((1,), float(np.float32(s_m)), dtype=torch.float32,
                        device=cc.device) if np.isscalar(s_m) else
             torch.from_numpy(np.asarray(s_m, np.float32)).to(cc.device)
             [:, None])
    base = (None if cc.force is None else
            torch.from_numpy(np.asarray(cc.force, np.float32)).to(cc.device))

    def step(f, t, Xm, Ub):
        pulled = pulled_state(cc, f, t)
        rho, mom = momentum(pulled)
        u_star = velocity(rho, mom, cc.force)
        safe_rho = torch.where(rho == 0, torch.ones_like(rho), rho)
        flat, weights = _support(Xm, shape)
        rho_m = interp(rho[None], flat, weights)                # (M, 1)
        F_grid = torch.zeros((3,) + shape, dtype=torch.float32,
                             device=f.device)
        u_cur = u_star
        for _ in range(n_iter):
            Um = interp(u_cur, flat, weights)                   # (M, 3)
            Fm = 2.0 * rho_m * (Ub - Um) * s_col
            dF = spread(Fm, flat, weights, shape)
            F_grid = F_grid + dF
            # the half-force shift updates u at once: the next sweep's
            # no-slip defect is measured against it
            u_cur = u_cur + 0.5 * dF / safe_rho[None]
        force = F_grid if base is None else half_force_base(F_grid, base)
        f_new, rho_out, u_out = step_tail(cc, f, pulled, force)
        return f_new, rho_out, u_out, F_grid

    return step


def marker_ring(center, radius, n, axis=1):
    """(n, 3) circle of markers in the plane normal to `axis` (a
    quasi-2D cylinder section; stack along the axis for a cylinder)."""
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    c = np.asarray(center, np.float64)
    lats = [a for a in range(3) if a != axis]
    out = np.tile(c, (n, 1))
    out[:, lats[0]] += radius * np.cos(th)
    out[:, lats[1]] += radius * np.sin(th)
    return out.astype(np.float32)


def marker_plane(coord, axis, shape, spacing=1.0):
    """Markers tiling the full lattice plane `axis` = coord at the given
    spacing (a plate; area per marker = spacing^2)."""
    lats = [a for a in range(3) if a != axis]
    a_ = np.arange(0.0, shape[lats[0]], spacing)
    b_ = np.arange(0.0, shape[lats[1]], spacing)
    A, B = np.meshgrid(a_, b_, indexing="ij")
    out = np.zeros((A.size, 3), np.float32)
    out[:, axis] = coord
    out[:, lats[0]] = A.ravel()
    out[:, lats[1]] = B.ravel()
    return out


class IBMFlow:
    """Prescribed-motion immersed boundaries on a case.

    markers: (M, 3) initial marker positions. motion: None (static
    markers, zero velocity) or a pair of callables (X_of_t, U_of_t) of the
    integer step returning (M, 3) positions and velocities (arrays or
    tensors). device: where the state lives ('cuda' unless the caller
    passes 'cpu'). graph: on CUDA, run() replays the step as a CUDA graph
    (engine/graph.py), the markers' positions and velocities copied in
    before each step when they move, unless False."""

    def __init__(self, spec: CaseSpec, markers, s_m=1.0, n_iter: int = 2,
                 motion: Optional[tuple] = None, device="cuda", graph=None):
        from lbm_tpu_torch.engine.runner import resolve_device

        self.spec = spec
        self.cc = compile_case(spec, resolve_device(device))
        self.step = make_ibm_step(self.cc, s_m=s_m, n_iter=n_iter)
        self.X0 = self._on_device(markers)
        self.motion = motion
        self.f = initial_f(self.cc)
        self.t = 0
        self._graph = graphable(self.cc, graph)

    def _on_device(self, a):
        return torch.as_tensor(a, dtype=torch.float32).to(self.cc.device)

    def _markers(self, t: int):
        if self.motion is None:
            return self.X0, torch.zeros_like(self.X0)
        return (self._on_device(self.motion[0](t)),
                self._on_device(self.motion[1](t)))

    def run(self, n_steps: int) -> None:
        n_steps = int(n_steps)
        if self._graph and n_steps:
            if self._graph is True:
                self._graph = StepGraph(
                    lambda f, X, U: (self.step(f, self.t, X, U)[0], X, U),
                    (self.f, *self._markers(self.t)))
            if self.motion is None:
                self.f = self._graph.run((self.f, *self._markers(0)),
                                         n_steps)[0]
            else:
                for k in range(n_steps):
                    self.f = self._graph.run(
                        (self.f, *self._markers(self.t + k)), 1)[0]
        else:
            f = self.f
            for k in range(n_steps):
                f = self.step(f, self.t + k, *self._markers(self.t + k))[0]
            self.f = f
        self.t += n_steps

    def macro(self):
        return macro_fields(self.cc, self.f)


__all__ = ["make_ibm_step", "interp", "spread", "marker_ring",
           "marker_plane", "half_force_base", "IBMFlow"]
