"""Two-way coupled thermal flow: Boussinesq natural convection (torch
port of lbm_tpu/engine/thermal.py).

The D3Q7 distribution of engine/scalar.py carries temperature, and the
Guo forcing scheme of engine/step.py feeds it back into the D3Q19
momentum equation as the buoyancy

    F(x, t) = buoyancy * (c(x, t) - c_ref),    buoyancy = g_vec * beta

at fluid cells (lattice units; only the product of gravity and the
expansion coefficient is observable). c = c_ref exerts no force and
CaseSpec.force, if any, stays the constant base (dense route only).

Per step the flow advances with the force built from the PREVIOUS step's
temperature, then the scalar advects in the new velocity: the ordering of
CoupledTransport, which this class extends with the feedback term and
with isothermal walls (scalar.dirichlet_walls). On the kernel route the
flow kernel's force-field instance (K1e) and the scalar kernel (K8) both
read the pre-step g; only the scalar kernel writes the other g buffer.

Dimensionless groups (H = wall-to-wall distance in cells, walls half-way
between the wall and fluid cell layers):

    Pr = nu / kappa,   Ra = |buoyancy| * dT * H^3 / (nu * kappa)

with nu = (tau - 1/2)/3 and kappa = (tau_g - 1/2)/4. The cases are made by
cases/thermal.py.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import momentum
from lbm_tpu_torch.engine.scalar import CoupledTransport
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.engine.step import init_override, velocity
from lbm_tpu_torch.kernels.collide_stream import ForceField


class BuoyantTransport(CoupledTransport):
    """Boussinesq-coupled flow and temperature on one case's geometry
    (the counterpart of lbm_tpu's BuoyantTransport, and with
    backend='kernel' of its BuoyantTransportPallas).

    spec: the flow CaseSpec. On the dense route the buoyancy composes with
       every collision operator and with CaseSpec.force; the kernel route
       takes BGK and TRT without a CaseSpec.force, as lbm_tpu's, and
       raises NotImplementedError naming backend='dense' otherwise.
       Plane-boundary NEE rewrites see only the static force.
    D / tau_g: lattice thermal diffusivity kappa (one of the two).
    buoyancy: 3-vector g_vec * beta per unit temperature.
    c_ref: the reference temperature exerting zero force.
    wall_c: (X, Y, Z) isothermal wall values (NaN = adiabatic), on any
       wall cells: the kernel applies the anti-bounce-back link inside
       its launch, so the walls need not be plates and the box may be
       periodic.
    inlet_c / source / c0: as in ScalarTransport.
    div_fix: dense route only, default off.
    f0: optional initial flow state.
    mesh, shard_axis: the dense route under a mesh, lbm_tpu's GSPMD
       mesh= (engine/scalar.py): the buoyancy is elementwise in the
       rank's c and needs nothing more; the energy series is the ranks'
       float64 partials added in rank order once a run() call; macro(),
       nusselt_profile, save and restore work on the gathered whole box,
       so a checkpoint restores at any world size. The kernel route
       refuses mesh= in lbm_tpu's words.
    """

    def __init__(self, spec: CaseSpec, D: Optional[float] = None,
                 tau_g: Optional[float] = None,
                 buoyancy=(0.0, 0.0, 0.0), c_ref: float = 0.0,
                 wall_c=None, inlet_c: Optional[dict] = None,
                 source: float = 0.0, c0=None, div_fix: bool = False,
                 f0=None, device="cuda", backend: str = "kernel", mesh=None,
                 shard_axis: Optional[int] = None):
        buoy = tuple(float(np.float32(v)) for v in buoyancy)
        if len(buoy) != 3:
            raise ValueError(f"buoyancy must be a 3-vector: {buoyancy!r}")
        if spec.boundaries and any(buoy):
            print("[lbm_tpu_torch] BuoyantTransport: plane boundaries "
                  "present: their NEE rewrites use the static "
                  "CaseSpec.force, not the per-cell buoyancy (second order "
                  "at open planes; closed thermal boxes are exact)",
                  flush=True)
        super().__init__(spec, D=D, tau_g=tau_g, inlet_c=inlet_c,
                         source=source, c0=c0, div_fix=div_fix,
                         wall_c=wall_c, f0=f0, device=device,
                         backend=backend,
                         field=ForceField(buoy, float(np.float32(c_ref))),
                         mesh=mesh, shard_axis=shard_axis)
        self.buoyancy = np.asarray(buoy, np.float32)
        self.c_ref = np.float32(c_ref)

    def run(self, n_steps: int, record_energy: bool = False):
        """Advance flow and temperature n_steps. record_energy (dense
        route): sample the kinetic energy sum(u^2 over fluid cells) of
        every step's in-step velocity and return the (n_steps,) float64
        series (the Rayleigh-Benard onset diagnostic; under a mesh the
        ranks' partials added in rank order), else None."""
        energy = None
        if record_energy:
            if self.backend != "dense":
                raise ValueError("record_energy samples the dense step's "
                                 "in-step velocity; pass backend='dense'")
            energy = torch.zeros(n_steps, dtype=torch.float64,
                                 device=self.cc.device)
        self._advance(n_steps, None, energy)
        if energy is None:
            return None
        energy = energy.cpu().numpy()
        if self.mesh is not None:
            energy = self.mesh.sum_in_rank_order(energy)
        return energy

    def _window_macro(self):
        """(rho, u) with the CURRENT buoyant force's half shift, u = (m +
        F/2) / rho, of the rows this process holds: moments at fluid
        cells, the init values elsewhere."""
        from lbm_tpu_torch.kernels import collide_stream as K

        force = self._force_field()
        if self.backend == "dense":
            rho, mom = momentum(self._f)
            u = velocity(rho, mom, force)
        else:
            # K3 gives m / rho; the per-cell shift is added to it
            rho, u = K.macro(self._f)
            safe = torch.where(rho == 0, torch.ones_like(rho), rho)
            u = u + 0.5 * force / safe[None]
        return init_override(self.cc, rho, u)

    # -- checkpoint / resume ----------------------------------------------
    def save(self, path: str) -> None:
        """Atomic npz checkpoint of the coupled state (f, g, t): written
        to a temporary name and renamed. Under a mesh every rank calls it
        and rank 0 writes the gathered whole box."""
        f, g = self.f.cpu().numpy(), self.g.cpu().numpy()
        if self.mesh is None or self.mesh.rank == 0:
            tmp = path + ".tmp"
            np.savez_compressed(
                tmp, f=f, g=g, t=np.int64(self.t),
                case=np.bytes_(self.spec.name.encode()))
            os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)
        if self.mesh is not None:
            self.mesh.barrier()

    def restore(self, path: str) -> None:
        """Restore a checkpoint written by save (here or by lbm_tpu),
        checking the case's name and shape; the resumed trajectory is
        bit-identical to the uninterrupted one."""
        with np.load(path) as d:
            case = bytes(d["case"]).decode()
            if case != self.spec.name:
                raise ValueError(
                    f"checkpoint is for case {case!r}, this transport is "
                    f"{self.spec.name!r}")
            shp = tuple(self.spec.shape)
            if d["f"].shape != (19,) + shp or d["g"].shape != (7,) + shp:
                raise ValueError(
                    f"checkpoint shapes f{d['f'].shape} / g{d['g'].shape} "
                    f"do not match this case's {shp}")
            self.set_f(np.ascontiguousarray(d["f"], dtype=np.float32))
            self.set_g(np.ascontiguousarray(d["g"], dtype=np.float32))
            self.t = int(d["t"])

    # -- diagnostics -------------------------------------------------------
    def nusselt_profile(self, hot_axis: int, kappa: float, dT: float,
                        H: float):
        """Per-plane Nusselt number along `hot_axis`: the total heat flux
        (advective u_a c + diffusive -kappa dc/da by central difference)
        through each interior lattice plane over its fluid cells,
        normalized by the conduction flux kappa dT / H per cell of wall
        area. At steady state the profile is the same on every plane; its
        mean is the cavity's Nusselt number. Summed in float64 on the
        device (the gathered whole box under a mesh). Returns (planes, Nu
        per plane) as NumPy arrays."""
        c = self.concentration().double().movedim(hot_axis, 0)
        ua = self.macro()[1][hot_axis].double().movedim(hot_axis, 0)
        fluid = self.fluid.movedim(hot_axis, 0)[2:-2]
        zero = torch.zeros((), dtype=torch.float64, device=c.device)
        flux = ua[2:-2] * c[2:-2] - kappa * 0.5 * (c[3:-1] - c[1:-3])
        total = torch.where(fluid, flux, zero).sum(dim=(1, 2))
        area = fluid.sum(dim=(1, 2))
        keep = (area > 0).cpu().numpy()
        nu = (total / (area.clamp(min=1) * (kappa * dT / H))).cpu().numpy()
        planes = np.arange(2, c.shape[0] - 2)
        return planes[keep], nu[keep]


__all__ = ["BuoyantTransport"]
