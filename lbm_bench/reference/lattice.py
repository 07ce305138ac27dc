"""D3Q19 constants and the moment and equilibrium arithmetic of the plain
reference, in fp32 and in a fixed operation order.

The order is the one the D3Q19 step is written in: sums over directions
added one direction at a time in direction order, e_i . u as
((ex ux + ey uy) + ez uz) (a zero term adds nothing, so this is the
signed sum of the nonzero components), and

    phi_i(u) = w_i (1 + 3 cu + 4.5 cu cu - 1.5 |u|^2),  feq = rho phi.

No matrix product is used, so no TF32 path applies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Q = 19
E = np.array(
    [[0, 0, 0],
     [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
     [1, 1, 0], [1, -1, 0], [-1, 1, 0], [-1, -1, 0],
     [1, 0, 1], [1, 0, -1], [-1, 0, 1], [-1, 0, -1],
     [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1]], dtype=np.int64)
W = np.array([1.0 / 3.0] + [1.0 / 18.0] * 6 + [1.0 / 36.0] * 12,
             dtype=np.float32)
OPP = np.array([0, 2, 1, 4, 3, 6, 5, 10, 9, 8, 7, 14, 13, 12, 11, 18, 17,
                16, 15], dtype=np.int64)

# cell labels
GHOST, DEAD, WALL, INLET, OUTLET, FLUID, MOVING = -1, 0, 1, 2, 3, 4, -2


def momentum(f):
    """(rho, [mx, my, mz]) of a (19, N) state, each summed in direction
    order."""
    rho = f[0]
    for i in range(1, Q):
        rho = rho + f[i]
    mom = []
    for a in range(3):
        acc = None
        for i in range(1, Q):
            s = int(E[i, a])
            if s == 0:
                continue
            if acc is None:
                acc = f[i] if s > 0 else -f[i]
            else:
                acc = acc + f[i] if s > 0 else acc - f[i]
        mom.append(acc)
    return rho, mom


def moments(f):
    """(rho, u) of a (19, N) fp32 state: u = m / rho (rho == 0 read as
    1)."""
    rho, mom = momentum(f)
    safe = torch.where(rho == 0, torch.ones_like(rho), rho)
    return rho, torch.stack([m / safe for m in mom])


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(E, W) as float32 tensors on `device`, made once: a step captured
    in a CUDA graph may copy nothing from the host."""
    return (torch.as_tensor(E, dtype=torch.float32, device=device),
            torch.as_tensor(W, dtype=torch.float32, device=device))


def phi(u):
    """(19, N) phi of a (3, N) velocity."""
    e, w = _tables(u.device)
    usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    cu = (e[:, 0:1] * u[0][None] + e[:, 1:2] * u[1][None]) \
        + e[:, 2:3] * u[2][None]
    return w[:, None] * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq[None])


def phi_pairs(u, dirs):
    """phi of pairs: u (3, P), dirs (P,) int64 tensor -> (P,)."""
    e, w = _tables(u.device)
    e, w = e[dirs], w[dirs]
    usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    cu = (e[:, 0] * u[0] + e[:, 1] * u[1]) + e[:, 2] * u[2]
    return w * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)


def phi_host(u, dirs):
    """(D,) float32 phi of one velocity (3 numbers) on the host, in NumPy
    fp32: the static boundary equilibria."""
    u = np.asarray(u, np.float32)
    out = []
    for i in dirs:
        cu = np.float32(0.0)
        for a in range(3):
            cu = np.float32(cu + np.float32(E[i, a]) * u[a])
        usq = np.float32(np.float32(u[0] * u[0] + u[1] * u[1]) + u[2] * u[2])
        out.append(np.float32(W[i] * np.float32(
            np.float32(np.float32(1.0) + np.float32(3.0) * cu)
            + np.float32(np.float32(4.5) * cu) * cu
            - np.float32(1.5) * usq)))
    return np.asarray(out, np.float32)


def feq(rho, u):
    """(19, N) equilibrium of (N,) rho and (3, N) u."""
    return rho[None] * phi(u)
