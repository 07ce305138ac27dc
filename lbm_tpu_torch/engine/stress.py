"""Deviatoric (viscous) stress and wall shear stress (WSS) on the dense
and the compacted live-cell layouts (torch port of
lbm_tpu/engine/stress.py).

From the non-equilibrium second moment of the PRE-collision state,

    Pi_ab = sum_i e_ia e_ib (f_i - f_i^eq),

the deviatoric stress is sigma_ab = -(1 - 1/(2 tau)) Pi_ab (the
Chapman-Enskog relation S_ab = -3/(2 rho tau) Pi_ab), with lbm_tpu's
refinements: the Guo force's missing (u_a F_b + u_b F_a)/2 added back, a
closure's per-cell tau_eff from the same P (core/rheology.tau_eff_from_p),
and the state pulled by engine/step.pulled_state (pulled_state_wk, with
the carried P_c, for windkessel outlets), since the stored f is
post-collision. WSS at a fluid cell next to a WALL/MOVING cell is the
magnitude of the tangential traction sigma.n - (n.sigma.n) n, n the
w_i-weighted inward voxel normal (or the SDF gradient with
CaseSpec.wall_sdf); multiply by units.C_pre for Pa. WSSAccumulator keeps
the time averages of the traction vector and its magnitude: TAWSS and
OSI = 1/2 (1 - |<t>| / <|t|>).

These are plain torch operations on the run's device: lbm_tpu computes
them outside any Pallas kernel, at output rate. The dense pull holds
about five (19, X, Y, Z) fp32 arrays at once (some 12 GB at the
291 x 291 x 372 coronary). The live-cell route (stress_fields_sparse,
wss_sparse, SparseWSSAccumulator) does the same arithmetic per cell on
the (19, n_live) state of engine/sparse.py, pulled by pulled_sparse:
only the output field is ever dense (Simulation.wss routes through it on
the sparse backend, and on the kernel backend past lbm_tpu's size rule).
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import D3Q19, _signed_sum, momentum, phi
from lbm_tpu_torch.core.rheology import tau_eff_from_p
from lbm_tpu_torch.engine.compile import CompiledCase
from lbm_tpu_torch.engine.step import pulled_state, pulled_state_wk, velocity
from lbm_tpu_torch.geometry.mask import CellType

_E = D3Q19.E
_F32 = np.float32

# the second-moment components, in the order xx yy zz xy xz yz
_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def stress_fields(cc: CompiledCase, f, t: int = 0, wk=None):
    """(sigma6, rho, u) of the pre-collision state pulled from f at step
    t: sigma6 (6, X, Y, Z) in the xx yy zz xy xz yz order, lattice units,
    zero at non-fluid cells; rho and u with macro_fields' convention
    (the initial values at non-fluid cells). wk: the carried P_c of a
    case with windkessel outlets (their rewrite's rho* depends on it)."""
    f = f.float()
    pulled = (pulled_state_wk(cc, f, t, wk)[0] if wk is not None
              else pulled_state(cc, f, t))
    return _sigma_from_pulled(pulled, cc)


def stress_fields_sparse(sc, f_s, t: int = 0, wk=None):
    """(sigma6, rho, u) on the compacted (19, n_live) layout of a
    SparseCase: the pull of engine/sparse.pulled_sparse (pulled_sparse_wk
    with the carried P_c) and stress_fields' arithmetic; scatter with
    engine/sparse.scatter_dense."""
    from lbm_tpu_torch.engine.sparse import pulled_sparse, pulled_sparse_wk

    f_s = f_s.float()
    pulled = (pulled_sparse_wk(sc, f_s, t, wk)[0] if wk is not None
              else pulled_sparse(sc, f_s, t))
    return _sigma_from_pulled(pulled, sc)


def _sigma_from_pulled(pulled, cc: CompiledCase):
    rho, mom = momentum(pulled)
    u = velocity(rho, mom, cc.force)
    safe = torch.where(rho == 0, torch.ones_like(rho), rho)
    fneq = pulled - rho[None] * phi(u)
    terms = [fneq[i] for i in range(D3Q19.Q)]
    pi6 = torch.stack([_signed_sum(terms, _E[:, a] * _E[:, b])
                       for a, b in _PAIRS])
    if cc.closure is not None:
        p = torch.sqrt(2.0 * (pi6[0] * pi6[0] + pi6[1] * pi6[1]
                              + pi6[2] * pi6[2]
                              + 2.0 * (pi6[3] * pi6[3] + pi6[4] * pi6[4]
                                       + pi6[5] * pi6[5])))
        te = tau_eff_from_p(p, torch.ones_like(rho) / safe, cc.tau,
                            cc.closure)
        pref = -(1.0 - torch.full((), 0.5, device=te.device) / te)[None]
    else:
        pref = float(_F32(-(1.0 - 0.5 / float(cc.tau))))
    if cc.force is not None:
        fv = [float(v) for v in np.asarray(cc.force, np.float32)]
        pi6 = pi6 + torch.stack([0.5 * (u[a] * fv[b] + u[b] * fv[a])
                                 for a, b in _PAIRS])
    sigma = torch.where(cc.fluid[None], pref * pi6,
                        torch.zeros((), device=pi6.device))
    rho = torch.where(cc.fluid, rho, cc.rho0)
    u = torch.where(cc.fluid[None], u, cc.u0)
    return sigma, rho, u


def wall_normals(mask, sdf=None) -> np.ndarray:
    """(3, X, Y, Z) f32 unit inward (fluid -> solid) wall normals at fluid
    cells with a WALL/MOVING lattice neighbor, zero elsewhere: the
    w_i-weighted sum of the directions into solid cells, or with `sdf`
    (CaseSpec.wall_sdf, positive in fluid) -grad(sdf)/|grad(sdf)| where
    the gradient does not degenerate (lbm_tpu's wall_normals, NumPy)."""
    m = np.asarray(mask)
    solid = (m == CellType.WALL) | (m == CellType.MOVING)
    fluid = m == CellType.FLUID
    n = np.zeros((3,) + m.shape, np.float32)
    w = D3Q19.W.astype(np.float32)
    for i in range(1, D3Q19.Q):
        e = _E[i]
        nb = np.roll(solid, shift=[-int(s) for s in e], axis=(0, 1, 2))
        sel = fluid & nb
        for a in range(3):
            if e[a]:
                n[a][sel] += w[i] * float(e[a])
    mag = np.sqrt((n * n).sum(axis=0))
    np.divide(n, mag[None], out=n, where=mag[None] > 0)
    if sdf is not None:
        g = np.stack(np.gradient(np.asarray(sdf, np.float64)))
        gmag = np.sqrt((g * g).sum(axis=0))
        ok = (mag > 0) & (gmag > 0.1)
        gn = (-g / np.where(gmag > 0, gmag, 1.0)).astype(np.float32)
        n = np.where(ok[None], gn, n)
    return n


def compact_normals(sc, normals_dense) -> torch.Tensor:
    """(3, n_live) fp32 live-cell compaction of a dense wall_normals
    field, on the case's device."""
    from lbm_tpu_torch.engine.sparse import gather_live

    n = torch.as_tensor(np.asarray(normals_dense, np.float32))
    return gather_live(sc, n).to(sc.device)


def _normals_on(cc: CompiledCase, normals):
    if normals is None:
        normals = wall_normals(cc.spec.mask, cc.spec.wall_sdf)
    return torch.as_tensor(normals, dtype=torch.float32, device=cc.device)


def _tangential(sigma, n):
    """The tangential traction vector of a (6, ...) sigma on (3, ...)
    unit normals."""
    tx = sigma[0] * n[0] + sigma[3] * n[1] + sigma[4] * n[2]
    ty = sigma[3] * n[0] + sigma[1] * n[1] + sigma[5] * n[2]
    tz = sigma[4] * n[0] + sigma[5] * n[1] + sigma[2] * n[2]
    tn = tx * n[0] + ty * n[1] + tz * n[2]
    return torch.stack([tx - tn * n[0], ty - tn * n[1], tz - tn * n[2]])


def tangential_traction(cc: CompiledCase, f, t: int = 0, normals=None,
                        wk=None):
    """(3, X, Y, Z) tangential wall traction vector (lattice units) at
    wall-adjacent fluid cells, zero elsewhere (OSI needs the vector's
    time average)."""
    n = _normals_on(cc, normals)
    sigma, _, _ = stress_fields(cc, f, t, wk=wk)
    return _tangential(sigma, n)


def _magnitude(w):
    return torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])


def wss_field(cc: CompiledCase, f, t: int = 0, normals=None, wk=None):
    """(X, Y, Z) wall shear stress magnitude (lattice units; times
    units.C_pre for Pa), nonzero only at wall-adjacent fluid cells.
    normals: a precomputed wall_normals (array or tensor)."""
    n = _normals_on(cc, normals)
    w = tangential_traction(cc, f, t, n, wk=wk)
    return torch.where((n != 0).any(dim=0), _magnitude(w),
                       torch.zeros((), device=w.device))


def wss_sparse(sc, f_s, t: int = 0, normals=None, wk=None):
    """(n_live,) wall shear stress magnitude on the compacted layout
    (stress_fields_sparse); normals: a compact_normals field to reuse."""
    if normals is None:
        normals = compact_normals(sc, wall_normals(sc.spec.mask,
                                                   sc.spec.wall_sdf))
    sigma, _, _ = stress_fields_sparse(sc, f_s, t, wk=wk)
    w = _tangential(sigma, normals)
    return torch.where((normals != 0).any(dim=0), _magnitude(w),
                       torch.zeros((), device=w.device))


class WSSAccumulator:
    """Time statistics of the wall traction on the dense layout: TAWSS =
    <|t_w|> and OSI = 1/2 (1 - |<t_w>| / <|t_w|>), zero where there is no
    wall. Sample uniformly over whole periods (run's on_save, or
    acc.sample_sim(sim) after each chunk)."""

    def __init__(self, cc: CompiledCase, normals=None):
        self.cc = cc
        self.normals = _normals_on(cc, normals)
        self._vec = torch.zeros((3,) + tuple(cc.shape), dtype=torch.float32,
                                device=cc.device)
        self._mag = torch.zeros(tuple(cc.shape), dtype=torch.float32,
                                device=cc.device)
        self.n_samples = 0

    def sample(self, f, t: int = 0, wk=None):
        w = tangential_traction(self.cc, f, t, self.normals, wk=wk)
        self._vec = self._vec + w
        self._mag = self._mag + _magnitude(w)
        self.n_samples += 1

    def sample_sim(self, sim):
        """Sample a Simulation's current state (either backend)."""
        cc, f = sim._dense_cc_f()
        if cc is not self.cc:
            raise ValueError("the accumulator is bound to a different case")
        self.sample(f, sim.t, wk=sim.wk)

    def tawss_field(self):
        """(X, Y, Z) time-averaged WSS (lattice units)."""
        if self.n_samples == 0:
            raise ValueError("no sample taken")
        return self._mag / _F32(self.n_samples)

    def osi_field(self):
        """(X, Y, Z) oscillatory shear index in [0, 1/2]."""
        if self.n_samples == 0:
            raise ValueError("no sample taken")
        mean_vec = torch.sqrt(self._vec[0] ** 2 + self._vec[1] ** 2
                              + self._vec[2] ** 2)
        has = self._mag > 0
        safe = torch.where(has, self._mag, torch.ones_like(self._mag))
        return torch.where(has, 0.5 * (1.0 - mean_vec / safe),
                           torch.zeros_like(safe))


class SparseWSSAccumulator(WSSAccumulator):
    """WSSAccumulator on the compacted layout of a SparseCase: tawss() and
    osi() are (n_live,), tawss_field() and osi_field() scattered to (X,
    Y, Z)."""

    def __init__(self, sc, normals=None):
        self.sc = sc
        self.normals = (compact_normals(sc, wall_normals(sc.spec.mask,
                                                         sc.spec.wall_sdf))
                        if normals is None else normals)
        self._vec = torch.zeros((3, sc.n_live), dtype=torch.float32,
                                device=sc.device)
        self._mag = torch.zeros(sc.n_live, dtype=torch.float32,
                                device=sc.device)
        self.n_samples = 0

    def sample(self, f_s, t: int = 0, wk=None):
        sigma, _, _ = stress_fields_sparse(self.sc, f_s, t, wk=wk)
        w = _tangential(sigma, self.normals)
        self._vec = self._vec + w
        self._mag = self._mag + _magnitude(w)
        self.n_samples += 1

    def sample_sim(self, sim):
        """Sample a Simulation's current state on its live-cell route."""
        sc, f_s = sim._sparse_cc_f()
        if sc is not self.sc:
            raise ValueError("the accumulator is bound to a different case")
        self.sample(f_s, sim.t, wk=sim.wk)

    def tawss(self):
        """(n_live,) time-averaged WSS (lattice units)."""
        return WSSAccumulator.tawss_field(self)

    def osi(self):
        """(n_live,) oscillatory shear index."""
        return WSSAccumulator.osi_field(self)

    def tawss_field(self):
        from lbm_tpu_torch.engine.sparse import scatter_dense

        return scatter_dense(self.sc, self.tawss())

    def osi_field(self):
        from lbm_tpu_torch.engine.sparse import scatter_dense

        return scatter_dense(self.sc, self.osi())


__all__ = ["stress_fields", "stress_fields_sparse", "wall_normals",
           "compact_normals", "tangential_traction", "wss_field",
           "wss_sparse", "WSSAccumulator", "SparseWSSAccumulator"]
