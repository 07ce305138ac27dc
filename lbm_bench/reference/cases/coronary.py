"""The coronary tree of the reference's coronary_cfd/coronary.cu on a
synthetic branched tube (its geo.txt is not shipped): a main tube of
`radius` along x from x = 3 to x = nx - 4 at (y, z) = ((ny - 1) / 2,
nz // 4), and three branches along +z at x = nx // 3, nx // 2, 2 nx // 3,
capped at z = nz - 3 bw, nz - 2 bw, nz - bw (bw = radius + 2).

Labels as coronary.cu derives them: a 3-pass erosion of the occupancy
(interior cells FLUID, its surface WALL), in-plane passes for the inlet
(2) at x = 3, the main outlet (3) at x = nx - 4 and the sub-outlets (5,
6, 7) on their caps, inside a window of bw about each branch axis, then
the DEAD cells next to a wall marked GHOST.

Boundaries: the inlet, rho* = 1 and u* = 0.1745 / C_U along x (with
`pulsatile` = (nphase, period) scaled by a periodic waveform); without
`windkessel` the main outlet (rho extrapolated, u* = 0.1 / C_U along x)
and the sub-outlets (rho extrapolated, u* = 0.02 / C_U along z); with
`windkessel`, four (Rp, C, Rd) triples (main, then the sub-outlets), each
outlet rho* = 1 + 3 (Q Rp + P_c), u extrapolated. u0 holds the
prescribed speeds on the boundary cells."""

from __future__ import annotations

import numpy as np

from lbm_bench.reference.geometry import Geometry, Plane
from lbm_bench.reference.lattice import (
    DEAD,
    E,
    GHOST,
    INLET,
    OUTLET,
    Q,
    WALL,
)

C_U = 2.74909090909091


def _min6(flag):
    m = np.minimum(flag[2:, 1:-1, 1:-1], flag[:-2, 1:-1, 1:-1])
    m = np.minimum(m, np.minimum(flag[1:-1, 2:, 1:-1], flag[1:-1, :-2, 1:-1]))
    return np.minimum(m, np.minimum(flag[1:-1, 1:-1, 2:], flag[1:-1, 1:-1, :-2]))


def _end_plane(geo, flag, axis, coord, passes, window=None):
    """geo[plane cell] += passes * min(4 in-plane neighbours of flag)."""
    plane = np.take(flag, coord, axis=axis)
    a_n, b_n = plane.shape
    wa, wb = window or (slice(1, a_n - 1), slice(1, b_n - 1))
    m = np.minimum(plane[wa.start + 1:wa.stop + 1, wb],
                   plane[wa.start - 1:wa.stop - 1, wb])
    m = np.minimum(m, plane[wa, wb.start + 1:wb.stop + 1])
    m = np.minimum(m, plane[wa, wb.start - 1:wb.stop - 1])
    idx = [slice(None)] * 3
    lat = [a for a in range(3) if a != axis]
    idx[axis], idx[lat[0]], idx[lat[1]] = coord, wa, wb
    geo[tuple(idx)] += passes * m


def tree_mask(nx, ny, nz, radius):
    """(labels, inlet_x, outlet_x, the sub-outlets' cap planes)."""
    inlet_x, outlet_x = 3, nx - 4
    bw = radius + 2
    branch_xs = [nx // 3, nx // 2, 2 * nx // 3]
    caps = [nz - 3 * bw, nz - 2 * bw, nz - bw]
    cy, cz = (ny - 1) / 2.0, nz // 4
    x = np.arange(nx)[:, None, None]
    y = np.arange(ny)[None, :, None]
    z = np.arange(nz)[None, None, :]
    flag = (((y - cy) ** 2 + (z - cz) ** 2 <= float(radius) ** 2)
            & (x >= inlet_x) & (x <= outlet_x))
    for bx, cap in zip(branch_xs, caps):
        flag = flag | (((x - bx) ** 2 + (y - cy) ** 2 <= radius ** 2)
                       & (z >= cz) & (z <= cap))
    flag = flag.astype(np.int32)
    flag[0], flag[-1] = 0, 0
    flag[:, 0], flag[:, -1] = 0, 0
    flag[:, :, 0], flag[:, :, -1] = 0, 0
    geo = flag.copy()
    geo[1:-1, 1:-1, 1:-1] += 3 * _min6(flag)
    _end_plane(geo, flag, 0, inlet_x, 1)
    _end_plane(geo, flag, 0, outlet_x, 2)
    icy = (ny - 1) // 2
    for k, (bx, cap) in enumerate(zip(branch_xs, caps)):
        _end_plane(geo, flag, 2, cap, 4 + k,
                   (slice(bx - bw, bx + bw), slice(icy - bw, icy + bw)))
    # DEAD cells next to an interior wall become GHOST
    src = np.zeros(geo.shape, bool)
    src[1:-1, 1:-1, 1:-1] = geo[1:-1, 1:-1, 1:-1] == WALL
    near = np.zeros_like(src)
    for i in range(1, Q):
        near |= np.roll(src, shift=tuple(int(v) for v in E[i]),
                        axis=(0, 1, 2))
    geo[(geo == DEAD) & near] = GHOST
    return geo, inlet_x, outlet_x, caps


def waveform(nphase, base=0.6, amp=0.4):
    t = np.linspace(0.0, 2 * np.pi, nphase, endpoint=False)
    w = base + amp * (np.sin(t) + 0.35 * np.sin(2 * t + 0.8))
    return np.clip(w, 0.05, None).astype(np.float32)


def build(shape=(128, 64, 96), radius: int = 10, tau: float = 0.55,
          pulsatile=None, windkessel=None) -> Geometry:
    nx, ny, nz = (int(v) for v in shape)
    mask, inlet_x, outlet_x, caps = tree_mask(nx, ny, nz, int(radius))
    u_in = 0.1745 / C_U
    if pulsatile is not None:
        nphase, period = (int(v) for v in pulsatile)
        series = np.zeros((nphase, 3), np.float32)
        series[:, 0] = waveform(nphase) * u_in
        inlet = Plane(label=INLET, axis=0, coord=inlet_x, normal=1,
                      rho="fixed", rho_value=1.0, u="series", series=series,
                      stride=max(1, period // nphase))
    else:
        inlet = Plane(label=INLET, axis=0, coord=inlet_x, normal=1,
                      rho="fixed", rho_value=1.0, u="fixed",
                      u_value=(u_in, 0.0, 0.0))
    planes = [inlet]
    outlets = [(OUTLET, 0, outlet_x)] + [(5 + k, 2, cap)
                                         for k, cap in enumerate(caps)]
    if windkessel is not None:
        if len(windkessel) != len(outlets):
            raise ValueError("one (Rp, C, Rd) an outlet: main, then the "
                             "three sub-outlets")
        for (label, axis, coord), wk in zip(outlets, windkessel):
            planes.append(Plane(label=label, axis=axis, coord=coord,
                                normal=-1, rho="fixed", rho_value=1.0,
                                u="extrapolate",
                                windkessel=tuple(float(v) for v in wk)))
    else:
        planes.append(Plane(label=OUTLET, axis=0, coord=outlet_x, normal=-1,
                            rho="extrapolate", u="fixed",
                            u_value=(0.1 / C_U, 0.0, 0.0)))
        for label, _, coord in outlets[1:]:
            planes.append(Plane(label=label, axis=2, coord=coord, normal=-1,
                                rho="extrapolate", u="fixed",
                                u_value=(0.0, 0.0, 0.02 / C_U)))
    u0 = np.zeros((3, nx, ny, nz), np.float32)
    u0[0][mask == INLET] = u_in
    if windkessel is None:
        u0[0][mask == OUTLET] = 0.1 / C_U
        for label in (5, 6, 7):
            u0[2][mask == label] = 0.02 / C_U
    return Geometry(shape=(nx, ny, nz), mask=mask, u0=u0, tau=float(tau),
                    planes=planes, residual="usq")
