"""The plain reference step: D3Q19 BGK over a geometry's fluid cells in
plain PyTorch, fp32, with TF32 off (no product here could take it).

For fluid cell x and direction i, with s = x - e_i wrapped on every axis:

    pulled_i(x) = f_opp(i)(x)               s a WALL (half-way bounce-back)
                = f_i(s)                    otherwise (a cell that is not
                                            fluid keeps its initial state)
                = rho* phi*_i + (f_i(x) - rho_p phi_i(u_p)) (1 - 1/tau)
                                            s on a boundary plane, labelled
                                            as it, e_i along its normal
    rho = sum pulled, u = m / rho, f'(x) = pulled - (pulled - rho phi(u)) / tau

rho_p, u_p are the moments of x's own pre-step populations; rho* is the
plane's fixed rho, rho_p, or an RCR outlet's 1 + 3 (Q Rp + P_c'), where Q
is the outward sum of u_p along the normal over the plane's labelled
footprint (taken on the next plane inward) and P_c' = (P_c + Q / C) /
(1 + 1 / (Rd C)); phi* is the plane's fixed or phased velocity's, or
phi(u_p). Each step records the velsum, the float64 sum of |u| over the
fluid cells.

The state is held as the fluid cells' 19 populations and, after them,
the initial populations of every other cell a fluid cell reads, in one
flat buffer that one gather a step reads from. Nothing here imports the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_bench.reference.geometry import Geometry
from lbm_bench.reference.lattice import E, FLUID, OPP, Q, WALL, feq, \
    moments, phi, phi_host, phi_pairs


def _f32(v) -> np.float32:
    return np.float32(v)


def replay(device, step, n: int) -> None:
    """Call step() n times. On a CUDA device it runs twice, then is
    captured once as a CUDA graph and replayed: the same kernels without
    the host's launch of each (step may then read and write only device
    tensors whose addresses stay put)."""
    eager = n if device.type != "cuda" or n < 4 else 2
    if eager == n:
        for _ in range(n):
            step()
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(eager):
            step()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(n - eager):
        graph.replay()


class Stepper:
    """The reference's run of `geom` on `device`; `noise`, a (3, X, Y, Z)
    float32 array, is added to u0 on the fluid cells (the seed's
    inputs). store: the type the populations are held in between steps
    (float32; bfloat16 rounds them after every step, the control's lower
    precision)."""

    def __init__(self, geom: Geometry, noise: np.ndarray | None, device,
                 store: torch.dtype = torch.float32):
        self.geom = geom
        self.store = store
        self.device = torch.device(device)
        dev = self.device
        X, Y, Z = geom.shape
        self.shape = (X, Y, Z)
        mask = torch.as_tensor(geom.mask.reshape(-1), device=dev)
        u0 = geom.u0.copy()
        if noise is not None:
            u0 = np.where(geom.fluid[None], u0 + noise, u0).astype(np.float32)
        self.u0 = u0
        fl = torch.nonzero(mask == FLUID).reshape(-1)
        self.fluid_ids = fl
        nF = self.nF = int(fl.numel())
        fid = torch.full((X * Y * Z,), -1, dtype=torch.int64, device=dev)
        fid[fl] = torch.arange(nF, device=dev)
        self._fid = fid
        xs, ys, zs = fl // (Y * Z), (fl // Z) % Y, fl % Z
        self._xyz = (xs, ys, zs)
        # the non-fluid cells read: pull sources, and the footprints below
        srcs = []
        for i in range(1, Q):
            ex, ey, ez = (int(v) for v in E[i])
            srcs.append((((xs - ex) % X) * Y + (ys - ey) % Y) * Z
                        + (zs - ez) % Z)
        self._mask = mask
        planes = geom.planes
        foot = []
        for p in planes:
            if p.windkessel is None:
                continue
            cells = torch.nonzero(self._plane_cells(p, p.coord) ==
                                  p.label).reshape(-1)
            foot.append(self._on_plane(p, cells, p.coord + p.normal))
        extra = [s[(mask[s] != FLUID) & (mask[s] != WALL)] for s in srcs]
        extra += [c[mask[c] != FLUID] for c in foot]
        const = torch.unique(torch.cat(extra)) if extra else fl[:0]
        self.nC = nC = int(const.numel())
        cid = torch.full((X * Y * Z,), -1, dtype=torch.int64, device=dev)
        cid[const] = torch.arange(nC, device=dev)
        self._cid = cid
        self._const = const
        # the gather table: (19, nF) flat positions into the buffer
        k = torch.arange(nF, device=dev)
        rows = [k]
        for i in range(1, Q):
            s = srcs[i - 1]
            lab = mask[s]
            rows.append(torch.where(
                lab == WALL, int(OPP[i]) * nF + k,
                torch.where(lab == FLUID, i * nF + fid[s].clamp(min=0),
                            Q * nF + i * nC + cid[s].clamp(min=0))))
        self._idx = torch.stack(rows).reshape(-1)
        del rows
        # the boundary pairs (fluid cell, direction) and their constants
        pk, pd, pb = [], [], []
        for b, p in enumerate(planes):
            for d in p.dirs:
                s = srcs[d - 1]
                on = (mask[s] == p.label) & (
                    self._axis_coord(s, p.axis) == p.coord)
                sel = torch.nonzero(on).reshape(-1)
                pk.append(sel)
                pd.append(torch.full_like(sel, d))
                pb.append(torch.full_like(sel, b))
        self._pk = torch.cat(pk)
        self._pd = torch.cat(pd)
        pb = torch.cat(pb)
        self._cons, self._pc = torch.unique(self._pk, return_inverse=True)
        self._cons_idx = (torch.arange(Q, device=dev)[:, None] * nF
                          + self._cons[None]).reshape(-1)
        P = int(self._pk.numel())
        pd_h, pb_h = self._pd.cpu().numpy(), pb.cpu().numpy()
        phi_const = np.zeros(P, np.float32)
        rho_const = np.zeros(P, np.float32)
        self._series = []
        for b, p in enumerate(planes):
            on = pb_h == b
            if p.rho == "fixed":
                rho_const[on] = _f32(p.rho_value)
            if p.u == "fixed":
                tab = phi_host(p.u_value, range(Q))
                phi_const[on] = tab[pd_h[on]]
            elif p.u == "series":
                tabs = np.stack([phi_host(u, range(Q))[pd_h]
                                 for u in p.series])
                self._series.append((torch.as_tensor(on, device=dev),
                                     torch.as_tensor(tabs, device=dev),
                                     p.stride))
        self._phi_const = torch.as_tensor(phi_const, device=dev)
        self._rho_const = torch.as_tensor(rho_const, device=dev)
        self._extrap_u = torch.as_tensor(
            np.isin(pb_h, [b for b, p in enumerate(planes)
                           if p.u == "extrapolate"]), device=dev)
        self._extrap_rho = torch.as_tensor(
            np.isin(pb_h, [b for b, p in enumerate(planes)
                           if p.rho == "extrapolate"]), device=dev)
        self._omega = float(_f32(1.0) - _f32(1.0) / _f32(geom.tau))
        self._tau = torch.full((), float(_f32(geom.tau)),
                               dtype=torch.float32, device=dev)
        # RCR outlets: footprints, constants, carried P_c
        wk_planes = [(b, p) for b, p in enumerate(planes)
                     if p.windkessel is not None]
        self.wk = None
        if wk_planes:
            # every outlet's footprint in one gather; its flux along its
            # axis, summed a segment an outlet
            self._foot_idx = self._state_index(torch.cat(foot))
            self._foot_axis = torch.cat([torch.full_like(c, p.axis) for c, (
                _, p) in zip(foot, wk_planes)])[None]
            ends = np.cumsum([int(c.numel()) for c in foot])
            self._foot_seg = [(int(a), int(b), float(-p.normal)) for a, b, (
                _, p) in zip(np.r_[0, ends[:-1]], ends, wk_planes)]
            rp, cap, rd = (np.asarray([_f32(p.windkessel[j])
                                       for _, p in wk_planes], np.float32)
                           for j in range(3))
            denom = (_f32(1.0) + _f32(1.0) / (rd * cap)).astype(np.float32)
            self._wk_c = [torch.as_tensor(a, device=dev)
                          for a in (rp, cap, denom)]
            self._wk_rho = torch.as_tensor(
                np.asarray([_f32(p.rho_value) for _, p in wk_planes],
                           np.float32), device=dev)
            slot = np.full(len(planes), -1)
            for j, (b, _) in enumerate(wk_planes):
                slot[b] = j
            pw = slot[pb_h]
            self._wk_pair = torch.as_tensor(pw >= 0, device=dev)
            self._wk_slot = torch.as_tensor(np.maximum(pw, 0), device=dev)
            self.wk = torch.zeros(len(wk_planes), dtype=torch.float32,
                                  device=dev)
        # the usq residual's cells: interior fluid cells
        self._interior = ((xs >= 1) & (xs <= X - 2) & (ys >= 2)
                          & (ys <= Y - 3) & (zs >= 1) & (zs <= Z - 2))
        self.buf = torch.empty(Q * nF + Q * nC, dtype=torch.float32,
                               device=dev)
        # the step count and the series slot, on the device, so that a
        # captured step reads them where it replays
        self._t_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.reset()

    # -- geometry helpers ---------------------------------------------------
    def _axis_coord(self, flat, axis):
        X, Y, Z = self.shape
        return (flat // (Y * Z), (flat // Z) % Y, flat % Z)[axis]

    def _plane_cells(self, p, coord):
        """mask labels of plane `coord` of p.axis, flattened."""
        m = self.geom.mask
        return torch.as_tensor(np.ascontiguousarray(
            np.take(m, coord, axis=p.axis)).reshape(-1), device=self.device)

    def _on_plane(self, p, lat_ids, coord):
        """Flat box ids of the cells at lateral ids `lat_ids` of the plane
        `coord` of p.axis."""
        X, Y, Z = self.shape
        dims = [d for a, d in enumerate((X, Y, Z)) if a != p.axis]
        a, b = lat_ids // dims[1], lat_ids % dims[1]
        xyz = [None, None, None]
        lat = [ax for ax in range(3) if ax != p.axis]
        xyz[p.axis] = torch.full_like(a, coord)
        xyz[lat[0]], xyz[lat[1]] = a, b
        return (xyz[0] * Y + xyz[1]) * Z + xyz[2]

    def _state_index(self, cells):
        """(19 * n,) buffer positions of box cells (fluid or held
        constant)."""
        fid, cid = self._fid[cells], self._cid[cells]
        if bool(((fid < 0) & (cid < 0)).any()):
            raise ValueError("a cell the step reads is neither fluid nor "
                             "held")
        i = torch.arange(Q, device=self.device)[:, None]
        return torch.where(fid[None] >= 0, i * self.nF + fid[None],
                           Q * self.nF + i * self.nC + cid[None]).reshape(-1)

    def initial(self, cells):
        """(19, n) initial populations of box cells: feq(1, u0)."""
        u = torch.as_tensor(self.u0.reshape(3, -1)[:, cells.cpu().numpy()],
                            device=self.device)
        return feq(torch.ones(u.shape[1], device=self.device), u)

    # -- state ----------------------------------------------------------------
    def _round(self, x):
        return x if self.store == torch.float32 else x.to(self.store).float()

    def reset(self):
        nF = self.nF
        self.buf[:Q * nF] = self._round(self.initial(self.fluid_ids)).reshape(-1)
        self.buf[Q * nF:] = self._round(self.initial(self._const)).reshape(-1)
        self.t = 0
        self._t_dev.fill_(0)
        if self.wk is not None:
            self.wk.copy_(torch.as_tensor(np.asarray(
                [p.p0 for p in self.geom.planes if p.windkessel is not None],
                np.float32)))

    def load(self, f, t: int, wk=None):
        """Take a (19, X, Y, Z) state's fluid cells, its step count and
        its carried P_c (the program's, where the check follows it)."""
        f = f.reshape(Q, -1)
        self.buf[:Q * self.nF] = f[:, self.fluid_ids].float().reshape(-1)
        self.t = int(t)
        self._t_dev.fill_(self.t)
        if wk is not None:
            self.wk.copy_(wk.detach())

    @property
    def f_fluid(self):
        return self.buf[:Q * self.nF].view(Q, self.nF)

    # -- stepping -------------------------------------------------------------
    def step(self, series):
        """One step; its velsum goes to series[slot], slot advancing."""
        nF = self.nF
        pre = self.f_fluid
        pulled = self.buf.index_select(0, self._idx).view(Q, nF)
        rho_star = self._rho_const
        if self.wk is not None:
            _, uf = moments(self.buf.index_select(0, self._foot_idx)
                            .view(Q, -1))
            ua = uf.gather(0, self._foot_axis)[0]
            q = torch.stack([sign * ua[a:b].sum()
                             for a, b, sign in self._foot_seg])
            rp, cap, denom = self._wk_c
            p_new = (self.wk + q / cap) / denom
            p_in = q * rp + p_new
            self.wk.copy_(p_new)
            rho_wk = self._wk_rho + 3.0 * p_in
            rho_star = torch.where(self._wk_pair, rho_wk[self._wk_slot],
                                   rho_star)
        cons = self.buf.index_select(0, self._cons_idx).view(Q, -1)
        rho_p, u_p = moments(cons)
        phi_nbr = phi_pairs(u_p[:, self._pc], self._pd)
        feq_nbr = rho_p[self._pc] * phi_nbr
        phi_star = self._phi_const
        for on, tabs, stride in self._series:
            phase = torch.remainder(torch.div(self._t_dev, stride,
                                              rounding_mode="floor"),
                                    len(tabs))
            phi_star = torch.where(on, tabs.index_select(0, phase.view(1))[0],
                                   phi_star)
        phi_star = torch.where(self._extrap_u, phi_nbr, phi_star)
        rho_star = torch.where(self._extrap_rho, rho_p[self._pc], rho_star)
        src = cons[self._pd, self._pc]
        pulled[self._pd, self._pk] = (rho_star * phi_star
                                      + (src - feq_nbr) * self._omega)
        rho, u = moments(pulled)
        f_eq = rho[None] * phi(u)
        post = pulled - (pulled - f_eq) / self._tau
        speed = torch.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
        series.index_copy_(0, self._slot, speed.sum(dtype=torch.float64)
                           .view(1))
        pre.copy_(self._round(post))
        self._t_dev.add_(1)
        self._slot.add_(1)

    def run(self, n: int):
        """n steps; returns their velsum series (float64, on the host,
        the non-fluid offset added)."""
        series = torch.empty(n, dtype=torch.float64, device=self.device)
        self._slot.zero_()
        replay(self.device, lambda: self.step(series), n)
        self.t += n
        return series.cpu().numpy() + self.velsum_offset()

    # -- outputs ----------------------------------------------------------------
    def velsum_offset(self) -> float:
        """sum over the non-fluid cells of |u0|, float64."""
        flat = self.u0.reshape(3, -1)
        speed = np.sqrt(np.sum(flat.astype(np.float64) ** 2, axis=0))
        return float(np.sum(speed[~self.geom.fluid.reshape(-1)],
                            dtype=np.float64))

    def usq(self) -> float:
        """sum of |u|^2 over the interior fluid cells, float64."""
        _, u = moments(self.f_fluid)
        usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
        return float(torch.where(self._interior, usq, 0.0).sum(
            dtype=torch.float64))

    def full_state(self):
        """The (19, X, Y, Z) float32 state: the fluid cells' populations,
        every other cell's initial ones."""
        X, Y, Z = self.shape
        f = torch.empty((Q, X * Y * Z), dtype=torch.float32,
                        device=self.device)
        step = max(1, (1 << 24) // (Y * Z)) * (Y * Z)
        for c0 in range(0, X * Y * Z, step):
            cells = torch.arange(c0, min(c0 + step, X * Y * Z),
                                 device=self.device)
            f[:, c0:c0 + len(cells)] = self._round(self.initial(cells))
        f[:, self.fluid_ids] = self.f_fluid
        return f.view(Q, X, Y, Z)

    def max_abs_diff(self, f_part, xs) -> float:
        """max |f_part - this state| over every cell of the x planes `xs`
        (f_part: (19, len(xs), Y, Z), any float dtype); cells that are not
        fluid are held to their initial state."""
        X, Y, Z = self.shape
        worst = 0.0
        xs = list(xs)
        for j0 in range(0, len(xs), 8):
            part = xs[j0:j0 + 8]
            cells = (torch.as_tensor(part, device=self.device)[:, None]
                     * (Y * Z) + torch.arange(Y * Z, device=self.device)
                     [None]).reshape(-1)
            ref = self.initial(cells)
            fid = self._fid[cells]
            on = fid >= 0
            ref[:, on] = self.f_fluid[:, fid[on]]
            got = f_part[:, j0:j0 + len(part)].reshape(Q, -1).float()
            worst = max(worst, float((got - ref).abs().max()))
        return worst
