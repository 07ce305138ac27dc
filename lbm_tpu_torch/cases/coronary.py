"""Coronary artery tree (reference: coronary_cfd/coronary.cu), as in
lbm_tpu/cases/coronary.py.

291 x 291 x 372 grid, one velocity+pressure inlet at x=3 (rho* = 1 and
u* = 0.1745/C_U), main outlet at x=272 (rho extrapolated, u* = 0.1/C_U),
three sub-outlets on z planes labeled 5/6/7 (rho extrapolated,
u* = 0.02/C_U along +z, applied to the -z directions), tau = 0.55, the
u^2-windowed residual.

The reference's geo.txt is not shipped with it, so `build()` also makes
a synthetic branched tree with the same boundary structure: a main tube
along x and three side branches along +z, each capped by its z-plane
sub-outlet. `pulsatile=(nphase, period_steps)` gates the steady plug
inlet with the curved vessel's pulse waveform (a u_mode='series' inlet).
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.cases import register
from lbm_tpu_torch.core.lattice import D3Q19
from lbm_tpu_torch.core.units import UnitSystem
from lbm_tpu_torch.engine.spec import CaseSpec, PlaneBC
from lbm_tpu_torch.geometry.io import load_geo
from lbm_tpu_torch.geometry.mask import (
    CellType,
    end_plane_min_label,
    erode_label,
    ghost_dilate,
)

REAL_SHAPE = (291, 291, 372)
C_U = 2.74909090909091
CH = 6.1111e-05


def build_labels(
    flag: np.ndarray,
    inlet_x: int,
    outlet_x: int,
    subs: list[tuple[int, tuple[slice, slice] | None]],
) -> np.ndarray:
    """coronary.cu's label derivation: full-interior 3-pass erosion,
    in-plane min passes for the inlet (1), main outlet (2) and
    sub-outlets (4/5/6 -> labels 5/6/7), wall-sourced ghost dilation."""
    geo = erode_label(flag, passes=3)
    geo = end_plane_min_label(geo, flag, axis=0, coord=inlet_x, passes=1)
    geo = end_plane_min_label(geo, flag, axis=0, coord=outlet_x, passes=2)
    for k, (z, window) in enumerate(subs):
        geo = end_plane_min_label(
            geo, flag, axis=2, coord=z, passes=4 + k, window=window)
    return ghost_dilate(geo, source_labels=(CellType.WALL,))


def synthetic_tree_flag(
    nx: int, ny: int, nz: int, radius: int, inlet_x: int, outlet_x: int,
    branch_xs: list[int], branch_z_caps: list[int],
    stenosis=None,
) -> np.ndarray:
    """A branched-tube occupancy grid with the coronary BC topology: a
    main tube along x (capped at inlet_x/outlet_x) and side branches along
    +z (capped at their z plane).

    stenosis: optional (severity, x_center, length), a smooth cosine
    constriction of the main tube, r(x) = radius (1 - severity
    cos^2(pi (x - xc)/length)) for |x - xc| < length/2; severity is the
    fractional diameter reduction at the throat."""
    cy, cz = (ny - 1) / 2.0, nz // 4
    y = np.arange(ny)[None, :, None]
    z = np.arange(nz)[None, None, :]
    x = np.arange(nx)[:, None, None]
    r_main = np.full((nx, 1, 1), float(radius))
    if stenosis is not None:
        sev, xc, length = (float(v) for v in stenosis)
        if not (0.0 < sev < 1.0 and length > 0):
            raise ValueError(f"stenosis needs 0 < severity < 1 and a "
                             f"positive length: {stenosis}")
        xs = np.arange(nx, dtype=np.float64)
        inside = np.abs(xs - xc) < length / 2.0
        shrink = 1.0 - sev * np.cos(np.pi * (xs - xc) / length) ** 2
        r_main = np.where(inside, radius * shrink, radius)[:, None, None]
    main = (((y - cy) ** 2 + (z - cz) ** 2 <= r_main**2)
            & (x >= inlet_x) & (x <= outlet_x))
    flag = main
    for bx, zcap in zip(branch_xs, branch_z_caps):
        br = (((x - bx) ** 2 + (y - cy) ** 2 <= radius**2)
              & (z >= cz) & (z <= zcap))
        flag = flag | br
    flag = flag.astype(np.int32)
    flag[0], flag[-1] = 0, 0
    flag[:, 0], flag[:, -1] = 0, 0
    flag[:, :, 0], flag[:, :, -1] = 0, 0
    return flag


def synthetic_tree_sdf(nx: int, ny: int, nz: int, radius: float,
                       branch_xs: list[int]) -> np.ndarray:
    """Signed distance to the branched-tube union surface (positive
    inside): max over the main tube's and each branch's cylinder SDF.
    End caps are BC planes, handled by labels."""
    cy, cz = (ny - 1) / 2.0, nz // 4
    y = np.arange(ny, dtype=np.float64)[None, :, None]
    z = np.arange(nz, dtype=np.float64)[None, None, :]
    x = np.arange(nx, dtype=np.float64)[:, None, None]
    sdf = radius - np.sqrt((y - cy) ** 2 + (z - cz) ** 2)
    sdf = np.broadcast_to(sdf, (nx, ny, nz)).copy()
    for bx in branch_xs:
        br = radius - np.sqrt((x - bx) ** 2 + (y - cy) ** 2)
        # a branch exists only above the main axis plane z >= cz
        np.maximum(sdf, np.where(z >= cz, br, -np.inf), out=sdf)
    return sdf.astype(np.float32)


def curved_tree_mask(
    nx: int, ny: int, nz: int, radius: float, inlet_x: int, outlet_x: int,
    branch_xs: list[int], branch_z_caps: list[int], sdf: np.ndarray,
) -> np.ndarray:
    """Curved-wall (Bouzidi) variant of the synthetic-tree mask: FLUID
    where the SDF is positive (within the axis caps), WALL the first solid
    shell on the lateral surface only, then the voxel route's ghost
    dilation."""
    cy, cz = (ny - 1) / 2.0, nz // 4
    y = np.arange(ny)[None, :, None]
    z = np.arange(nz)[None, None, :]
    x = np.arange(nx)[:, None, None]
    in_any = np.broadcast_to((x >= inlet_x) & (x <= outlet_x),
                             (nx, ny, nz)).copy()
    for bx, zcap in zip(branch_xs, branch_z_caps):
        rbr = np.sqrt((x - bx) ** 2 + (y - cy) ** 2)
        in_any |= (rbr <= radius) & (z >= cz) & (z <= zcap)
    fluid = (sdf > 0.0) & in_any
    near = np.zeros_like(fluid)
    for i in range(1, D3Q19.Q):
        ex, ey, ez = (int(v) for v in D3Q19.E[i])
        near |= np.roll(fluid, shift=(ex, ey, ez), axis=(0, 1, 2))
    wall = near & ~fluid & (sdf <= 0.0)
    mask = np.zeros((nx, ny, nz), np.int32)
    mask[wall] = CellType.WALL
    mask[fluid] = CellType.FLUID
    return ghost_dilate(mask, source_labels=(CellType.WALL,))


def _relabel_plane(mask, axis, coord, label, window=None):
    """Set the FLUID cells of one plane (optionally windowed in its two
    lateral axes) to `label`: the curved variant's end-plane labels."""
    idx: list = [slice(None)] * 3
    idx[axis] = coord
    if window is not None:
        lat = [a for a in range(3) if a != axis]
        idx[lat[0]], idx[lat[1]] = window
    plane = mask[tuple(idx)]
    plane[plane == CellType.FLUID] = label
    mask[tuple(idx)] = plane
    return mask


def _boundaries(inlet_x, outlet_x, sub_planes, sub_labels,
                windkessel=None, pulsatile=None,
                shape=None, inlet_scale: float = 1.0) -> list[PlaneBC]:
    """The reference's prescribed-velocity outlets, or with `windkessel`
    (four (Rp, C, Rd) lattice tuples: main outlet, sub-outlets 5, 6, 7)
    pressure outlets coupled to RCR terminations."""
    u_in = inlet_scale * 0.1745 / C_U
    if pulsatile is not None:
        # the steady plug inlet scaled by the periodic pulse waveform
        from lbm_tpu_torch.cases.curved_vessel import pulse_waveform

        nphase, period_steps = (int(v) for v in pulsatile)
        wave = pulse_waveform(nphase)
        a, b = shape[1], shape[2]
        series = np.zeros((nphase, 3, a, b), np.float32)
        series[:, 0] = (wave * u_in)[:, None, None]
        inlet = PlaneBC(
            mask_value=int(CellType.INLET), axis=0, coord=inlet_x,
            normal=+1, rho_mode="fixed", rho_value=1.0,
            u_mode="series", u_series=series,
            u_series_stride=max(1, period_steps // nphase),
        )
    else:
        # rho* = 1 and u* prescribed at the inlet
        inlet = PlaneBC(
            mask_value=int(CellType.INLET), axis=0, coord=inlet_x,
            normal=+1, rho_mode="fixed", rho_value=1.0, u_mode="fixed",
            u_value=(u_in, 0.0, 0.0),
        )
    bcs = [inlet]
    if windkessel is not None:
        wk = [tuple(float(v) for v in w) for w in windkessel]
        if len(wk) != 1 + len(sub_planes):
            raise ValueError("coronary windkessel wants one (Rp, C, Rd) per "
                             "outlet: [main, sub5, sub6, sub7]")
        bcs.append(PlaneBC(
            mask_value=int(CellType.OUTLET), axis=0, coord=outlet_x,
            normal=-1, rho_mode="fixed", rho_value=1.0,
            u_mode="extrapolate", windkessel=wk[0],
        ))
        for k, (label, z) in enumerate(zip(sub_labels, sub_planes)):
            bcs.append(PlaneBC(
                mask_value=label, axis=2, coord=z, normal=-1,
                rho_mode="fixed", rho_value=1.0, u_mode="extrapolate",
                windkessel=wk[1 + k],
            ))
        return bcs
    # main outlet: rho extrapolated, u* = 0.1/C_U
    bcs.append(PlaneBC(
        mask_value=int(CellType.OUTLET), axis=0, coord=outlet_x, normal=-1,
        rho_mode="extrapolate", u_mode="fixed",
        u_value=(0.1 / C_U, 0.0, 0.0),
    ))
    for label, z in zip(sub_labels, sub_planes):
        # sub-outlets: the -z directions, u* = +0.02/C_U along z
        bcs.append(PlaneBC(
            mask_value=label, axis=2, coord=z, normal=-1,
            rho_mode="extrapolate", u_mode="fixed",
            u_value=(0.0, 0.0, 0.02 / C_U),
        ))
    return bcs


# the last few synthetic voxel trees' labels, by (shape, radius,
# stenosis): a run's cases that share a geometry (windkessel, pulsatile,
# collision variants) build its tree once
_LABELS: dict = {}
_LABELS_KEPT = 4


def _memo_labels(key: tuple, make) -> np.ndarray:
    """make()'s labels, built once a key (the _LABELS_KEPT last used
    kept), a fresh copy."""
    labels = _LABELS.pop(key, None)
    if labels is None:
        labels = make()
        while len(_LABELS) >= _LABELS_KEPT:
            _LABELS.pop(next(iter(_LABELS)))
    _LABELS[key] = labels
    return labels.copy()


@register("coronary")
def build(
    geo_path: str | None = None,
    tau: float = 0.55,
    max_steps: int = 300000,
    time_save: int = 5000,
    tol: float = 1e-6,
    shape: tuple[int, int, int] = (128, 64, 96),
    radius: int = 10,
    curved: bool = False,
    collision: str = "bgk",
    magic_lambda: float = 0.1875,
    mrt_rates=None,
    smagorinsky_cs=None,
    rheology=None,
    force=None,
    windkessel=None,
    pulsatile=None,
    inlet_scale: float = 1.0,
    hyperemia: float = 1.0,
    stenosis: float | None = None,
) -> CaseSpec:
    """geo_path: the reference's geo.txt ('yxz' order, REAL_SHAPE);
    without it the synthetic tree of `shape` and `radius` is built.
    curved: Bouzidi walls on the synthetic tree's SDF (the dense and
    sparse backends; the kernel backend refuses them). windkessel: see
    _boundaries.
    pulsatile: (nphase, period_steps) series inlet. inlet_scale: lattice
    inlet speed multiplier. hyperemia: physical flow multiplier at fixed
    lattice speed (C_U *= h, tau -> 1/2 + (tau - 1/2)/h). stenosis:
    fractional diameter reduction of a cosine constriction of the main
    tube (synthetic voxel route only)."""
    if hyperemia < 1.0:
        raise ValueError("hyperemia is a flow multiplier (>= 1)")
    units = UnitSystem(CH=CH, C_U=C_U * hyperemia, C_rho=1060.0)
    if hyperemia != 1.0:
        tau = 0.5 + (tau - 0.5) / hyperemia
        if tau <= 0.5005:
            raise ValueError(f"hyperemia={hyperemia} drives tau to "
                             f"{tau:.5f}: too stiff")
    wall_sdf = None
    if stenosis is not None and (geo_path is not None or curved):
        raise ValueError("stenosis= is a knob of the synthetic voxel route")
    if geo_path is not None:
        if curved:
            raise ValueError("curved=True needs the synthetic tree's SDF")
        flag = load_geo(geo_path, REAL_SHAPE, order="yxz")
        inlet_x, outlet_x = 3, 272
        subs = [
            (185, (slice(217, 237), slice(113, 138))),
            (191, (slice(160, 206), slice(159, 200))),
            (204, None),
        ]
        mask = build_labels(flag, inlet_x, outlet_x, subs)
        shape = REAL_SHAPE
    else:
        nx, ny, nz = shape
        inlet_x, outlet_x = 3, nx - 4
        bw = radius + 2
        branch_xs = [nx // 3, nx // 2, 2 * nx // 3]
        caps = [nz - 3 * bw, nz - 2 * bw, nz - bw]
        cy = (ny - 1) // 2
        subs = [
            (caps[k], (slice(branch_xs[k] - bw, branch_xs[k] + bw),
                       slice(cy - bw, cy + bw)))
            for k in range(3)
        ]
        if curved:
            # off-grid radius so no link is accidentally half-way
            wall_sdf = synthetic_tree_sdf(nx, ny, nz, radius - 0.28,
                                          branch_xs)
            mask = curved_tree_mask(nx, ny, nz, radius - 0.28, inlet_x,
                                    outlet_x, branch_xs, caps, wall_sdf)
            mask = _relabel_plane(mask, 0, inlet_x, CellType.INLET)
            mask = _relabel_plane(mask, 0, outlet_x, CellType.OUTLET)
            for k, (zc, window) in enumerate(subs):
                mask = _relabel_plane(mask, 2, zc, 5 + k, window)
        else:
            sten = None
            if stenosis is not None:
                # proximal lesion midway between the inlet and the first
                # branch, 3 diameters long
                sten = (float(stenosis), (inlet_x + branch_xs[0]) / 2.0,
                        3.0 * radius)
            mask = _memo_labels(
                (tuple(shape), radius, sten),
                lambda: build_labels(
                    synthetic_tree_flag(nx, ny, nz, radius, inlet_x,
                                        outlet_x, branch_xs, caps,
                                        stenosis=sten),
                    inlet_x, outlet_x, subs))

    sub_planes = [s[0] for s in subs]
    bcs = _boundaries(inlet_x, outlet_x, sub_planes, sub_labels=(5, 6, 7),
                      windkessel=windkessel, pulsatile=pulsatile,
                      shape=tuple(shape), inlet_scale=inlet_scale)
    u0 = np.zeros((3,) + tuple(shape), np.float32)
    # the prescribed BC speeds in the initial macro fields
    u0[0][mask == CellType.INLET] = inlet_scale * 0.1745 / C_U
    if windkessel is None:
        u0[0][mask == CellType.OUTLET] = 0.1 / C_U
        for label in (5, 6, 7):
            u0[2][mask == label] = 0.02 / C_U
    return CaseSpec(
        collision=collision,
        magic_lambda=magic_lambda,
        mrt_rates=mrt_rates,
        smagorinsky_cs=smagorinsky_cs,
        rheology=rheology,
        force=force,
        name="coronary",
        shape=tuple(shape),
        tau=tau,
        units=units,
        mask=mask,
        wall_sdf=wall_sdf,
        boundaries=bcs,
        u0=u0,
        max_steps=max_steps,
        time_save=time_save,
        tol=tol,
        stag_max=10**9,
        residual_flavor="usq",
        vtk_crops=(1, 2, 1),
        vtk_density=True,
        usq_includes_outlet_labels=False,
    )
