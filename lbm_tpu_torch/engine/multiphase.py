"""Shan-Chen pseudopotential multiphase flow: single-component liquid-vapor
with surface tension (torch port of lbm_tpu/engine/multiphase.py).

The interaction is the nearest-neighbor pseudopotential sum over the
D3Q19 stencil,

    F(x) = -G psi(x) sum_i w_i psi(x + e_i) e_i ,   psi(rho) = 1 - exp(-rho)

applied through the dense step's per-cell Guo forcing (step.
make_step_force). Bulk equation of state (c_s^2 = 1/3): p = rho/3 + (G/6)
psi(rho)^2, non-monotone below the critical coupling G_c = -4, where a
uniform fluid at rho ~ ln 2 separates into liquid and vapor.

Periodic-box physics (mask all FLUID, no boundaries). These are torch ops
on the case's device: lbm_tpu steps Shan-Chen through its XLA dense step,
with no Pallas kernel.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.core.lattice import D3Q19, momentum, phi
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.graph import StepGraph, graphable
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.engine.step import (
    initial_f,
    make_step_force,
    velocity,
)


def psi_of(rho):
    """Shan-Chen pseudopotential psi(rho) = 1 - e^{-rho}."""
    return 1.0 - torch.exp(-rho)


def sc_force(rho, G: float):
    """(3, X, Y, Z) interaction force field of the density field: F = -G
    psi sum_i w_i psi(x + e_i) e_i (18 rolls in direction order, each
    component accumulated in that order; pairwise antisymmetric, so the
    box total is zero)."""
    psi = psi_of(rho)
    acc = [torch.zeros_like(rho) for _ in range(3)]
    for i in range(1, D3Q19.Q):
        e = [int(v) for v in D3Q19.E[i]]
        axes = [a for a, s in enumerate(e) if s]
        nb = torch.roll(psi, shifts=[-e[a] for a in axes], dims=axes)
        w = float(D3Q19.W[i])
        for a in axes:
            acc[a] = acc[a] + (w * e[a]) * nb
    return (-G) * psi[None] * torch.stack(acc)


def eos_pressure(rho, G: float):
    """Bulk EOS p(rho) = rho/3 + (G/6) psi^2 (equal across coexisting
    bulks at mechanical equilibrium)."""
    psi = psi_of(rho)
    return rho / 3.0 + (G / 6.0) * (psi * psi)


def density(f):
    """rho = sum_i f_i in direction order."""
    return momentum(f)[0]


class ShanChen:
    """Single-component multiphase on a (typically fully periodic) case:
    each step the density's pseudopotential force rebuilds and drives the
    flow through the runtime-force step.

    G: the coupling (phase separation below -4). rho_init: an (X, Y, Z)
    initial density (array or tensor; default the case's rho0), at rest.
    device: where the state lives ('cuda' unless the caller passes
    'cpu'). graph: on CUDA, run() replays the step as a CUDA graph
    (engine/graph.py; the eager step's state bit for bit) unless False."""

    def __init__(self, spec: CaseSpec, G: float, rho_init=None,
                 device="cuda", graph=None):
        from lbm_tpu_torch.engine.runner import resolve_device

        if spec.force is not None:
            raise ValueError("the SC force replaces CaseSpec.force")
        self.spec = spec
        self.G = float(G)
        self.cc = compile_case(spec, resolve_device(device))
        self._step = make_step_force(self.cc)
        if rho_init is None:
            self.f = initial_f(self.cc)
        else:
            rho0 = torch.as_tensor(rho_init, dtype=torch.float32).to(
                self.cc.device)
            u0 = torch.zeros((3,) + tuple(rho0.shape), dtype=torch.float32,
                             device=self.cc.device)
            self.f = (rho0[None] * phi(u0)).contiguous()
        self.t = 0
        self._graph = graphable(self.cc, graph)

    def _one(self, f, t: int):
        return (self._step(f, t, sc_force(density(f), self.G))[0],)

    def run(self, n_steps: int) -> None:
        if self._graph:
            if self._graph is True:
                self._graph = StepGraph(lambda f: self._one(f, self.t),
                                        (self.f,))
            (self.f,) = self._graph.run((self.f,), n_steps)
        else:
            f = self.f
            for k in range(int(n_steps)):
                (f,) = self._one(f, self.t + k)
            self.f = f
        self.t += int(n_steps)

    def rho(self):
        return density(self.f)

    def macro(self):
        """(rho, u) with the current interaction force's half shift (the
        Guo velocity)."""
        rho, mom = momentum(self.f)
        return rho, velocity(rho, mom, sc_force(rho, self.G))

    def pressure(self):
        """Bulk EOS pressure field (valid away from interfaces)."""
        return eos_pressure(self.rho(), self.G)

    def total_mass(self) -> float:
        return float(self.rho().sum(dtype=torch.float64))


__all__ = ["ShanChen", "sc_force", "psi_of", "eos_pressure", "density"]
