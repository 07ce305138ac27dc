"""Binary-liquid free-energy model: two immiscible liquids of equal density
tracked by an order parameter phi in [-1, 1] (torch port of
lbm_tpu/engine/binary.py). Landau free energy

    f(phi) = A (-phi^2/2 + phi^4/4) + kappa/2 |grad phi|^2 ,

chemical potential mu = A (phi^3 - phi) - kappa lap(phi), planar interface
phi = tanh(x / xi) with xi = sqrt(2 kappa / A), surface tension sigma =
(2 sqrt(2) / 3) sqrt(kappa A).

Per step:
  - the FLOW (the dense D3Q19 step, step.make_step_force) advances under
    the well-balanced interfacial force F = -phi grad(mu), zero wherever
    mu is uniform;
  - the ORDER PARAMETER rides a D3Q7 distribution (engine/scalar's Q7,
    E7, W7), pulled (periodic) and relaxed toward the Cahn-Hilliard
    equilibrium in the new velocity,
        g_i^eq = w_i (Gamma mu + phi e_i.u) / c_s2   (i > 0),
        g_0^eq = phi - sum_{i>0} g_i^eq,
    so d phi/dt + div(phi u) = M lap(mu), M = Gamma (tau_g - 1/2) c_s2
    (c_s2 = 1/4).
Gradients and Laplacians are periodic central differences. These are torch
ops on the case's device: lbm_tpu steps this model through its XLA dense
step, with no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import momentum
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.graph import StepGraph, graphable
from lbm_tpu_torch.engine.scalar import E7, Q7, W7
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.engine.step import _c, initial_f, make_step_force, pull_one

_INV_CS2 = 4.0     # 1 / c_s^2 of the D3Q7 weight set (1/4, 1/8 x 6)


def grad_c(field):
    """(3, ...) central-difference gradient (periodic)."""
    return torch.stack([
        0.5 * (torch.roll(field, -1, a) - torch.roll(field, 1, a))
        for a in range(3)])


def lap_c(field):
    """Central 7-point Laplacian (periodic)."""
    out = -6.0 * field
    for a in range(3):
        out = out + torch.roll(field, -1, a) + torch.roll(field, 1, a)
    return out


def chemical_potential(phi, A: float, kappa: float):
    """mu = A (phi^3 - phi) - kappa lap(phi); phi^3 as phi (phi phi), the
    multiplications of XLA's integer power in its order."""
    return A * (phi * (phi * phi) - phi) - kappa * lap_c(phi)


def interface_width(A: float, kappa: float) -> float:
    return float(np.sqrt(2.0 * kappa / A))


def surface_tension(A: float, kappa: float) -> float:
    return float(2.0 * np.sqrt(2.0) / 3.0 * np.sqrt(kappa * A))


def _g_eq(phi, mu, u, gamma: float):
    """(7, ...) Cahn-Hilliard equilibrium (moments phi, phi u, Gamma mu
    c_s2 I)."""
    eqs = []
    rest = phi
    for i in range(1, Q7):
        a = int(np.argmax(np.abs(E7[i])))
        s = float(E7[i][a])
        gi = float(W7[i] * _INV_CS2) * (gamma * mu + s * phi * u[a])
        eqs.append(gi)
        rest = rest - gi
    return torch.stack([rest] + eqs)


def order_parameter(g):
    """phi = sum_i g_i in channel order."""
    out = g[0]
    for i in range(1, g.shape[0]):
        out = out + g[i]
    return out


class BinaryFluid:
    """Two-liquid free-energy flow on a (typically fully periodic) case.

    A, kappa: the Landau constants; gamma: the mobility factor; tau_g: the
    D3Q7 relaxation time; phi_init: the (X, Y, Z) initial order parameter
    (array or tensor; default 0). device: where the state lives ('cuda'
    unless the caller passes 'cpu'). graph: on CUDA, run() replays the
    step as a CUDA graph (engine/graph.py; the eager step's state bit for
    bit) unless False."""

    def __init__(self, spec: CaseSpec, A: float = 0.04,
                 kappa: float = 0.04, gamma: float = 0.3,
                 tau_g: float = 0.8, phi_init=None, device="cuda",
                 graph=None):
        from lbm_tpu_torch.engine.runner import resolve_device

        if spec.force is not None:
            raise ValueError("the interfacial force replaces CaseSpec.force")
        self.spec = spec
        self.A, self.kappa, self.gamma = float(A), float(kappa), float(gamma)
        self.tau_g = float(tau_g)
        self.cc = compile_case(spec, resolve_device(device))
        self._step = make_step_force(self.cc)
        self.f = initial_f(self.cc)
        dev = self.cc.device
        shape = tuple(int(s) for s in spec.shape)
        phi0 = (torch.zeros(shape, dtype=torch.float32, device=dev)
                if phi_init is None else
                torch.as_tensor(phi_init, dtype=torch.float32).to(dev))
        u0 = torch.zeros((3,) + shape, dtype=torch.float32, device=dev)
        mu0 = chemical_potential(phi0, self.A, self.kappa)
        self.g = _g_eq(phi0, mu0, u0, self.gamma)
        self.t = 0
        self._graph = graphable(self.cc, graph)

    def _one(self, f, g, t: int):
        phi = order_parameter(g)
        mu = chemical_potential(phi, self.A, self.kappa)
        F = -phi[None] * grad_c(mu)   # well-balanced (module docstring)
        f, _, u = self._step(f, t, F)
        # stream the order parameter (periodic pulls, the value at x - e
        # arriving at x) + BGK toward the CH equilibrium in the new velocity
        pulled = torch.stack([g[0]] + [pull_one(g[i], E7[i])
                                       for i in range(1, Q7)])
        phi_n = order_parameter(pulled)
        mu_n = chemical_potential(phi_n, self.A, self.kappa)
        geq = _g_eq(phi_n, mu_n, u, self.gamma)
        g = pulled - (pulled - geq) / _c(self.tau_g, pulled)
        return f, g

    def run(self, n_steps: int) -> None:
        if self._graph:
            if self._graph is True:
                self._graph = StepGraph(
                    lambda f, g: self._one(f, g, self.t), (self.f, self.g))
            self.f, self.g = self._graph.run((self.f, self.g), n_steps)
        else:
            f, g = self.f, self.g
            for k in range(int(n_steps)):
                f, g = self._one(f, g, self.t + k)
            self.f, self.g = f, g
        self.t += int(n_steps)

    def phi(self):
        return order_parameter(self.g)

    def rho(self):
        return momentum(self.f)[0]

    def pressure(self):
        """Flow (ideal-gas) pressure rho/3."""
        return self.rho() / 3.0

    def total_phi(self) -> float:
        return float(self.phi().sum(dtype=torch.float64))


__all__ = ["BinaryFluid", "chemical_potential", "interface_width",
           "surface_tension", "grad_c", "lap_c", "order_parameter"]
