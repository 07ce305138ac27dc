"""The plain reference of a passive scalar carried by the flow: D3Q7
advection-diffusion, each step after the flow's, in the flow's new state.

For a cell x the step touches (the fluid cells, and the cells under a
boundary plane's labelled footprint on its next plane inward, whose
concentration the record reads, fluid or not) and channel i, with s = x -
e_i wrapped:

    v_i = g_opp(i)(x)                       s a WALL or MOVING cell
        = g_i(s)                            otherwise (0 off a cell that
                                            is not fluid)
        = c* phi_d + (g_d(x) - c_p phi_d) (1 - 1/tau_g)
                                            x under a plane's footprint,
                                            d its one crossing channel;
                                            c_p = sum g(x), c* the
                                            plane's prescribed c or c_p
    c = sum v,  g'_i(x) = v_i - (v_i - c phi_i) (1/tau_g)  (fluid x only)

phi_i = w_i (1 + 4 e_i.u), w = (1/4, 1/8 x 6), tau_g = 1/2 + 4 D, and u
the flow's new state's m (1/rho), each component zeroed where a
neighbour along its axis is a WALL or MOVING cell. Sums run in channel
order; 1/tau_g and 1 - 1/tau_g are fp32 constants. The record is each
plane's float64 mean of c over its footprint. Nothing here imports the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_bench.reference.lattice import E, FLUID, MOVING, OPP, WALL, momentum
from lbm_bench.reference.stepper import Stepper, replay

Q7 = 7
W7 = np.array([0.25] + [0.125] * 6, np.float32)


def tau_g_of(D: float) -> float:
    return 0.5 + 4.0 * float(D)


def bolus_table(bolus: dict) -> np.ndarray:
    """(period,) float32 c* of the bolus at (t - phase) mod period: 1 for
    the first `on` steps of each period, 0 after."""
    c = np.zeros(int(bolus["period"]), np.float32)
    c[:int(bolus["on"])] = 1.0
    return c


class Coupled:
    """The flow (a Stepper) and the scalar, stepped together; bolus: the
    inlet's {"boundary", "period", "on", "phase"}, the other planes zero
    gradient."""

    def __init__(self, flow: Stepper, D: float, bolus: dict):
        self.flow = flow
        geom, dev = flow.geom, flow.device
        self.device = dev
        X, Y, Z = geom.shape
        mask = flow._mask
        tau_g = tau_g_of(D)
        self._inv_tau = float(np.float32(1.0 / tau_g))
        self._omega = float(np.float32(1.0 - 1.0 / tau_g))
        nF = flow.nF
        # the touched cells: the fluid cells in the flow's order, then the
        # footprint cells that are not fluid
        feet, dirs = [], []
        for p in geom.planes:
            lat = torch.nonzero(flow._plane_cells(p, p.coord) == p.label
                                ).reshape(-1)
            feet.append(flow._on_plane(p, lat, p.coord + p.normal))
            dirs.append(next(i for i in range(1, Q7)
                             if int(E[i, p.axis]) * p.normal > 0))
        allfoot = torch.cat(feet)
        extra = torch.unique(allfoot[mask[allfoot] != FLUID])
        cells = torch.cat([flow.fluid_ids, extra])
        self._cells = cells
        self.nT = nT = int(cells.numel())
        self.nF = nF
        tid = torch.full((X * Y * Z,), -1, dtype=torch.int64, device=dev)
        tid[cells] = torch.arange(nT, device=dev)
        xs, ys, zs = cells // (Y * Z), (cells // Z) % Y, cells % Z
        blocking = (mask == WALL) | (mask == MOVING)
        zero = Q7 * nT           # a slot that holds 0.0
        k = torch.arange(nT, device=dev)
        rows, nbr_block = [k], []
        for i in range(1, Q7):
            ex, ey, ez = (int(v) for v in E[i])
            s = (((xs - ex) % X) * Y + (ys - ey) % Y) * Z + (zs - ez) % Z
            blk = blocking[s]
            nbr_block.append(blk)
            src_fluid = mask[s] == FLUID
            rows.append(torch.where(
                blk, int(OPP[i]) * nT + k,
                torch.where(src_fluid, i * nT + tid[s].clamp(min=0),
                            torch.full_like(k, zero))))
        self._idx = torch.stack(rows).reshape(-1)
        # an axis is blocked where either neighbour along it blocks
        self._blocked = torch.stack([nbr_block[2 * a] | nbr_block[2 * a + 1]
                                     for a in range(3)])
        # the planes' rewrite: touched ids, crossing channel, c* source
        self._foot = [tid[c] for c in feet]
        self._count = [max(int(c.numel()), 1) for c in feet]
        self._pk = torch.cat(self._foot)
        self._pd = torch.cat([torch.full_like(c, d)
                              for c, d in zip(self._foot, dirs)])
        b = int(bolus["boundary"])
        self._inlet = torch.cat([torch.full_like(c, j == b, dtype=torch.bool)
                                 for j, c in enumerate(self._foot)])
        self._bolus = torch.as_tensor(bolus_table(bolus), device=dev)
        self._phase = int(bolus["phase"])
        # the velocity of the touched cells that are not fluid: their
        # flow state is its initial one for good
        f0 = flow.initial(extra)
        self._u_extra = self._velocity(f0)
        self.g = torch.zeros(Q7 * nT + 1, dtype=torch.float32, device=dev)
        self._t_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._row = torch.zeros(1, dtype=torch.int64, device=dev)

    @staticmethod
    def _velocity(f):
        rho, mom = momentum(f)
        safe = torch.where(rho == 0, torch.ones_like(rho), rho)
        inv = torch.ones_like(rho) / safe
        return torch.stack([m * inv for m in mom])

    def load(self, f, g, t: int, wk=None):
        """Take the program's flow state, its (7, X, Y, Z) scalar state
        (at the touched cells) and its step count."""
        self.flow.load(f, t, wk)
        self.g[:Q7 * self.nT] = g.reshape(Q7, -1)[:, self._cells].float() \
            .reshape(-1)
        self._t_dev.fill_(int(t))

    def full_g(self):
        """The (7, X, Y, Z) scalar state: 0 at the cells not fluid."""
        X, Y, Z = self.flow.shape
        g = torch.zeros((Q7, X * Y * Z), dtype=torch.float32,
                        device=self.device)
        g[:, self.flow.fluid_ids] = self.g[:Q7 * self.nT].view(
            Q7, self.nT)[:, :self.nF]
        return g.view(Q7, X, Y, Z)

    def g_fluid_max_abs_diff(self, g_fluid) -> float:
        """max |g_fluid - this state| over the fluid cells (g_fluid: (7,
        n_fluid) in the box's flat order)."""
        own = self.g[:Q7 * self.nT].view(Q7, self.nT)[:, :self.nF]
        return float((g_fluid.float() - own).abs().max())

    def g_max_abs_diff(self, g_part, xs) -> float:
        """max |g_part - this state| over the x planes `xs` (g_part: (7,
        len(xs), Y, Z))."""
        ref = self.full_g()[:, list(xs)]
        return float((g_part.float() - ref).abs().max())

    def step(self, fseries, record):
        self.flow.step(fseries)
        nT, nF = self.nT, self.nF
        u = torch.cat([self._velocity(self.flow.f_fluid),
                       self._u_extra], dim=1)
        u = torch.where(self._blocked, torch.zeros_like(u), u)
        phi = [torch.full_like(u[0], float(W7[0]))]
        for i in range(1, Q7):
            a = int(np.argmax(np.abs(E[i])))
            s = int(E[i, a])
            phi.append(float(W7[i]) * (1.0 + (4.0 * s) * u[a]))
        phi = torch.stack(phi)
        own = self.g[:Q7 * nT].view(Q7, nT)
        pulled = self.g.index_select(0, self._idx).view(Q7, nT)
        mine = own[:, self._pk]
        c_p = mine[0]
        for i in range(1, Q7):
            c_p = c_p + mine[i]
        ph = phi[self._pd, self._pk]
        at = torch.remainder(self._t_dev - self._phase, len(self._bolus))
        c_star = torch.where(self._inlet,
                             self._bolus.index_select(0, at.view(1)), c_p)
        pulled[self._pd, self._pk] = (c_star * ph
                                      + (own[self._pd, self._pk] - c_p * ph)
                                      * self._omega)
        c = pulled[0]
        for i in range(1, Q7):
            c = c + pulled[i]
        post = pulled - (pulled - c * phi) * self._inv_tau
        rec = []
        for foot, count in zip(self._foot, self._count):
            rec.append(c[foot].sum(dtype=torch.float64) / count)
        record.index_copy_(0, self._row, torch.stack(rec)[None])
        own[:, :nF].copy_(self.flow._round(post[:, :nF]))
        self._t_dev.add_(1)
        self._row.add_(1)

    def run(self, n: int) -> np.ndarray:
        """n coupled steps; returns the (n, n_planes) float64 record."""
        fseries = torch.empty(n, dtype=torch.float64, device=self.device)
        record = torch.empty((n, len(self._foot)), dtype=torch.float64,
                             device=self.device)
        self.flow._slot.zero_()
        self._row.zero_()
        replay(self.device, lambda: self.step(fseries, record), n)
        self.flow.t += n
        return record.cpu().numpy()
