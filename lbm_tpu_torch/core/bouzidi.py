"""Bouzidi linear interpolated bounce-back for curved walls (a jax-free
copy of lbm_tpu/core/bouzidi.py).

For a fluid node x whose pull source x - e_j is a wall, with i = opp(j)
and post-collision populations f*, the wall link's value is

    q < 1/2 : f_j(x, t+1) = 2q f*_i(x) + (1 - 2q) f*_i(x + e_j)
    q >= 1/2: f_j(x, t+1) = 1/(2q) f*_i(x) + (1 - 1/(2q)) f*_j(x)

with q in (0, 1] the fractional distance from x to the wall surface
along the link; q = 1/2 is half-way bounce-back exactly. f*_i(x + e_j)
is direction i's own direct pull, so the step stays one pass.

q is sampled from the signed distance field CaseSpec.wall_sdf (positive
in fluid) at the linear zero crossing, q = sdf(x) / (sdf(x) - sdf(x -
e_j)), clipped to [q_min, 1]; where the second fluid node x + e_j of the
q < 1/2 branch is not FLUID the link falls back to q = 1/2.

`link_table` lists each direction's links (the fluid cells whose pull
source is a wall) with their q, in float64 arithmetic cast to float32
last, so every value is lbm_tpu's bit for bit; `link_q` spreads them
over the (19, X, Y, Z) array lbm_tpu builds (1/2 everywhere else).
`bouzidi_coeffs` computes the three coefficients in float32, as
lbm_tpu's step computes them from its float32 q.

The steps (engine/step.py dense, engine/sparse.py live cells) apply the
links after the half-way pull, all at once over the flattened (19 * N)
pulled state (`flat_links`, `apply_links`). `up`, direction opp(j)'s
direct pull at x (f*_i(x + e_j)), is read from that pulled state: where
b_up != 0 (q < 1/2) link_q has made x + e_j FLUID, so its pull is not a
wall's or a moving wall's and the pulled value is the direct one; where
b_up = 0 the value does not count.
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import D3Q19
from lbm_tpu_torch.geometry.mask import CellType

_E = D3Q19.E


def link_table(mask: np.ndarray, sdf: np.ndarray, q_min: float = 1e-3):
    """[(flat ids, q)] for j = 0..18: the C-order ids of the FLUID cells
    whose pull source x - e_j (wrapped) is a WALL, ascending, and their
    float32 q (lbm_tpu's link_q at those cells; empty for j = 0)."""
    mask = np.asarray(mask)
    sdf = np.asarray(sdf, np.float64)
    if sdf.shape != mask.shape:
        raise ValueError("wall_sdf must match the mask shape")
    shape = np.array(mask.shape)
    wall = mask == CellType.WALL
    fluid = mask == CellType.FLUID
    out = [(np.zeros(0, np.int64), np.zeros(0, np.float32))]
    for j in range(1, 19):
        ej = tuple(int(v) for v in _E[j])
        link = np.roll(wall, shift=ej, axis=(0, 1, 2)) & fluid
        ids = np.flatnonzero(link)
        x = np.stack(np.unravel_index(ids, mask.shape), axis=1)
        src = (x - _E[j]) % shape
        far = (x + _E[j]) % shape
        s = sdf.ravel()[ids]
        phi_s = sdf[src[:, 0], src[:, 1], src[:, 2]]
        denom = s - phi_s
        qj = np.where(np.abs(denom) > 1e-12,
                      s / np.where(denom == 0, 1.0, denom), 0.5)
        qj = np.clip(qj, q_min, 1.0)
        far_fluid = fluid[far[:, 0], far[:, 1], far[:, 2]]
        qj = np.where((qj < 0.5) & ~far_fluid, 0.5, qj)
        out.append((ids.astype(np.int64), qj.astype(np.float32)))
    return out


def link_q(mask: np.ndarray, sdf: np.ndarray, q_min: float = 1e-3,
           table=None) -> np.ndarray:
    """(19, nx, ny, nz) float32 per-pull-direction fractional wall
    distances, 1/2 wherever no link applies (lbm_tpu's link_q, bit for
    bit). table: a link_table of the same mask and sdf, if built."""
    mask = np.asarray(mask)
    if table is None:
        table = link_table(mask, sdf, q_min)
    q = np.full((19,) + mask.shape, 0.5, np.float32)
    for j, (ids, qj) in enumerate(table):
        q[j].ravel()[ids] = qj
    return q


def bouzidi_coeffs(q):
    """(a, b_up, b_loc) of a float32 q tensor, in float32: value = a f_i(x)
    + b_up f_i(x + e_j) + b_loc f_j(x), i = opp(j); (1, 0, 0) at q = 1/2.
    0.5 / q is a tensor division (PyTorch's scalar / tensor multiplies by
    a reciprocal)."""
    q = torch.as_tensor(q, dtype=torch.float32)
    lo = q < 0.5
    two_q = 2.0 * q
    inv2q = torch.full_like(q, 0.5) / q
    zero = torch.zeros_like(q)
    a = torch.where(lo, two_q, inv2q)
    b_up = torch.where(lo, 1.0 - two_q, zero)
    b_loc = torch.where(lo, zero, 1.0 - inv2q)
    return a, b_up, b_loc


def flat_links(table, n_cells: int, device, index=None):
    """The links of a link table over a flattened (19 * n_cells) state:
    (dst, opp_src, a, b_up, b_loc) on `device` (dst = j * n_cells + cell,
    opp_src = opp(j) * n_cells + cell), the cells' flat ids mapped through
    `index` (a flat array, e.g. the live-cell compaction) when given;
    None without a link."""
    dst, opp_src, qs = [], [], []
    for j, (ids, q) in enumerate(table):
        if len(ids) == 0:
            continue
        cell = ids if index is None else index[ids]
        dst.append(j * n_cells + cell)
        opp_src.append(int(D3Q19.OPP[j]) * n_cells + cell)
        qs.append(q)
    if not dst:
        return None
    dst, opp_src = (torch.from_numpy(np.concatenate(v).astype(np.int64))
                    .to(device) for v in (dst, opp_src))
    coeffs = bouzidi_coeffs(torch.from_numpy(np.concatenate(qs)))
    return (dst, opp_src) + tuple(c.to(device) for c in coeffs)


def apply_links(pulled, f, links):
    """Overwrite the links of a (19, ...) pulled state in place with
    a f[opp] + b_up up + b_loc f[j] (lbm_tpu's order), up read from the
    pulled state (see the module docstring); f is the pre-step state of
    the same layout. Returns pulled."""
    dst, opp_src, a, b_up, b_loc = links
    bz = (a * torch.take(f, opp_src) + b_up * torch.take(pulled, opp_src)
          + b_loc * torch.take(f, dst))
    pulled.view(-1).index_copy_(0, dst, bz)
    return pulled


__all__ = ["link_table", "link_q", "bouzidi_coeffs", "flat_links",
           "apply_links"]
