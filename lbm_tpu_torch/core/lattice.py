"""D3Q19 lattice: velocity set, weights, opposite pairs, equilibrium,
moments (torch port of lbm_tpu/core/lattice.py).

Velocity ordering (the CUDA reference's implicit convention):

  0        : rest
  1..6     : +x, -x, +y, -y, +z, -z
  7..10    : (+1,+1,0), (+1,-1,0), (-1,+1,0), (-1,-1,0)
  11..14   : (+1,0,+1), (+1,0,-1), (-1,0,+1), (-1,0,-1)
  15..18   : (0,+1,+1), (0,-1,+1), (0,+1,-1), (0,-1,-1)

Constants are NumPy; phi/feq/moments work on torch tensors in fp32. The
contractions over directions are written as explicit sums in direction
order (never tensordot/matmul), so no TF32 path can apply on a GPU and
the CUDA kernels (kernels/csrc/collide_stream.cu) can add in the same
order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _build_velocities() -> np.ndarray:
    return np.array(
        [
            [0, 0, 0],
            [1, 0, 0], [-1, 0, 0],
            [0, 1, 0], [0, -1, 0],
            [0, 0, 1], [0, 0, -1],
            [1, 1, 0], [1, -1, 0], [-1, 1, 0], [-1, -1, 0],
            [1, 0, 1], [1, 0, -1], [-1, 0, 1], [-1, 0, -1],
            [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
        ],
        dtype=np.int32,
    )


@dataclasses.dataclass(frozen=True)
class _D3Q19:
    """Immutable D3Q19 constants (NumPy on the host)."""

    Q: int = 19
    E: np.ndarray = dataclasses.field(default_factory=_build_velocities)
    W: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [1.0 / 3.0] + [1.0 / 18.0] * 6 + [1.0 / 36.0] * 12, dtype=np.float32
        )
    )
    OPP: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [0, 2, 1, 4, 3, 6, 5, 10, 9, 8, 7, 14, 13, 12, 11, 18, 17, 16, 15],
            dtype=np.int32,
        )
    )

    def dirs_into(self, axis: int, sign: int) -> np.ndarray:
        """Direction indices i with E[i, axis] * sign > 0: the populations
        a boundary plane with inward normal `sign` along `axis` must
        prescribe."""
        return np.nonzero(self.E[:, axis] * sign > 0)[0].astype(np.int32)


D3Q19 = _D3Q19()


def _signed_sum(terms, signs):
    """sum_k signs[k] * terms[k] over the nonzero signs (each +-1), added in
    order — the exact fp32 order the CUDA kernels use (0 +- x is exact, so
    a kernel that starts its accumulator at 0 agrees bit for bit)."""
    acc = None
    for t, s in zip(terms, signs):
        if s == 0:
            continue
        if acc is None:
            acc = t if s > 0 else -t
        else:
            acc = acc + t if s > 0 else acc - t
    return acc


def phi(u, dirs=None):
    """feq = rho * phi(u): phi_i(u) = w_i (1 + 3 e_i.u + 4.5 (e_i.u)^2 -
    1.5 |u|^2), in exactly this operation order.

    u: (3, ...) fp32 tensor. Returns (Q', ...) with Q' = len(dirs) or 19.
    """
    u = u.to(torch.float32).unbind(0)   # one view each, one backward node
    usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    dirs = range(D3Q19.Q) if dirs is None else [int(i) for i in dirs]
    out = []
    for i in dirs:
        cu = _signed_sum(u, D3Q19.E[i])  # e_i . u, summed x, y, z
        if cu is None:
            cu = torch.zeros_like(usq)
        w = float(D3Q19.W[i])
        out.append(w * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq))
    return torch.stack(out)


def feq(rho, u, dirs=None):
    """Second-order BGK equilibrium, feq_i = rho * phi_i(u).
    rho: (...); u: (3, ...). Returns (Q', ...)."""
    return rho.to(torch.float32)[None] * phi(u, dirs)


def momentum(f):
    """(rho, (mx, my, mz)): rho = sum_i f_i, m = sum_i e_i f_i, each summed
    in direction order. f is unbound once: under autograd its reads are
    one backward node, not one that fills a whole-state gradient for each
    direction read."""
    fs = f.unbind(0)
    rho = fs[0]
    for i in range(1, D3Q19.Q):
        rho = rho + fs[i]
    mom = tuple(_signed_sum(fs, D3Q19.E[:, a]) for a in range(3))
    return rho, mom


def moments(f):
    """Macroscopic density and velocity, u = sum_i e_i f_i / rho, with a
    rho == 0 cell read as rho = 1 for the division (its u is then 0).

    f: (19, ...). Returns (rho (...), u (3, ...)).
    """
    f = f.to(torch.float32)
    rho, mom = momentum(f)
    safe = torch.where(rho == 0, torch.ones_like(rho), rho)
    return rho, torch.stack([m / safe for m in mom])


__all__ = ["D3Q19", "feq", "phi", "moments", "momentum"]
