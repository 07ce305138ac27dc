"""The launch lists and descriptor rows of the two redesigned kernels,
against brute force on the CPU:

  - the collide-stream kernel takes the z-plane boundaries as descriptors
    of its own pass (axis 2, lateral index x * ny + y, a set of at most
    MAX_Z_BCS beside the MAX_BCS x/y planes): its rows, read the way the
    kernel reads them, rewrite the pulled state exactly as the dense step
    does, and every case of the port fits the two sets;
  - the D3Q7 scalar kernel launches over the fluid cells plus the cells
    under a footprint on its consumer plane, and its record sums each
    footprint's list of lateral indices.

The masks are lbm_tpu's for the same cases (the test imports both
packages)."""

import inspect
import os

import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu_torch.cases import bifurcation, coronary, get_case, list_cases
from lbm_tpu_torch.cases import thermal as thermal_cases
from lbm_tpu_torch.core.lattice import momentum, phi
from lbm_tpu_torch.engine.compile import (
    MAX_BCS,
    MAX_Z_BCS,
    check_supported,
    compile_case,
)
from lbm_tpu_torch.engine.scalar import (
    bc_geometry,
    compile_scalar,
    footprint_lists,
    plane_means,
    scalar_cell_ids,
)
from lbm_tpu_torch.engine.step import initial_f, pulled_state, velocity
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.kernels import collide_stream as K

import chip_smoke

CORONARY = dict(shape=(24, 20, 32), radius=4)
VESSELS = [
    ("coronary", CORONARY),
    ("coronary", dict(CORONARY, pulsatile=(4, 8))),
    ("coronary", dict(shape=(64, 48, 96), radius=4)),
    ("curved_vessel", dict(n=24, nphase=4, period_steps=8)),
    ("pipe", dict(n=36, curved=False)),
]


def brute_scalar_cells(mask, geo):
    """The ids of the cells a scalar step touches, by walking every cell:
    fluid, or on a boundary's consumer plane under its footprint."""
    mask = np.asarray(mask)
    nx, ny, nz = mask.shape
    out = []
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                keep = mask[x, y, z] == CellType.FLUID
                for _, axis, _, coord, plane in geo:
                    pos = (x, y, z)
                    lat = tuple(v for a, v in enumerate(pos) if a != axis)
                    keep |= pos[axis] == coord and bool(plane[lat])
                if keep:
                    out.append((x * ny + y) * nz + z)
    return out


@pytest.mark.parametrize("name,kw", VESSELS)
def test_scalar_cell_list_matches_brute_force(name, kw):
    """The scalar kernel's launch list on each vessel (lbm_tpu's mask)
    against a walk over the box; compile_scalar carries it on the device
    where the flow's SKIP_BELOW rule lists blocks, and it holds every
    fluid cell and every non-fluid cell under a footprint."""
    spec = get_case(name, **kw)
    np.testing.assert_array_equal(np.asarray(spec.mask), np.asarray(
        ref_get_case(name, **kw).mask))
    geo = bc_geometry(spec)
    ids = scalar_cell_ids(spec.mask, geo)
    assert ids.dtype == np.int32 and (np.diff(ids) > 0).all()
    assert ids.tolist() == brute_scalar_cells(spec.mask, geo)
    sc = compile_scalar(spec, "cpu", D=0.02)
    cc = compile_case(spec)
    assert (sc.cells is None) == (cc.fluid_cells is None)
    if sc.cells is not None:
        assert sc.cells.dtype == torch.int32
        assert sc.cells.tolist() == ids.tolist()
        fluid = set(cc.fluid_cells.tolist())
        assert fluid <= set(ids.tolist())
    mask = np.asarray(spec.mask).reshape(-1)
    assert (mask[ids] != CellType.FLUID).sum() == \
        len(ids) - int((mask == CellType.FLUID).sum())


@pytest.mark.parametrize("shape,share", [((40, 17, 30), 0.02),
                                         ((23, 9, 33), 0.004),
                                         ((12, 30, 8), 0.0)])
def test_scalar_cell_list_on_random_masks(shape, share):
    """Sparse random masks with a boundary on each axis whose footprints
    are random too, so they cover wall, DEAD and fluid cells of their
    consumer planes: the list against brute force (with no fluid cell,
    the footprints alone)."""
    rng = np.random.default_rng(11)
    draw = rng.random(shape)
    mask = np.full(shape, CellType.DEAD, np.int8)
    mask[draw < share] = CellType.FLUID
    mask[(draw >= share) & (draw < 3 * share)] = CellType.WALL
    geo = []
    for axis, coord in ((0, 1), (1, shape[1] - 2), (2, 3), (2, 5)):
        lat = tuple(n for a, n in enumerate(shape) if a != axis)
        geo.append((1 + 2 * axis, axis, 1, coord, rng.random(lat) < 0.2))
    ids = scalar_cell_ids(mask, geo)
    assert ids.tolist() == brute_scalar_cells(mask, geo)
    under = 0
    for _, axis, _, coord, plane in geo:
        under += int((np.take(mask, coord, axis=axis)[plane]
                      != CellType.FLUID).sum())
    assert under > 0 and len(ids) > int((mask == CellType.FLUID).sum())


@pytest.mark.parametrize("name,kw", VESSELS[:2] + VESSELS[3:])
def test_footprint_lists_match_brute_force(name, kw):
    """Each boundary's footprint list: the ascending flat lateral indices
    of its valid cells at its offsets; summing a plane of c over it, the
    way the record kernel does, gives plane_means' record."""
    spec = get_case(name, **kw)
    sc = compile_scalar(spec, "cpu", D=0.02)
    foot, off = sc.foot.numpy(), sc.foot_off
    assert off.dtype == np.int32 and off[0] == 0 and len(off) == \
        len(sc.bcs) + 1 and off[-1] == len(foot)
    for b, bc in enumerate(sc.bcs):
        valid = bc.valid.numpy()
        want = [a * valid.shape[1] + j for a in range(valid.shape[0])
                for j in range(valid.shape[1]) if valid[a, j]]
        assert foot[off[b]:off[b + 1]].tolist() == want
        assert max(len(want), 1) == bc.count
    c = torch.from_numpy(np.random.default_rng(2).random(
        sc.shape).astype(np.float32))
    rec = plane_means(c, sc.bcs)
    for b, bc in enumerate(sc.bcs):
        plane = c.select(bc.axis, bc.coord).reshape(-1).double()
        got = plane[torch.from_numpy(foot[off[b]:off[b + 1]]).long()].sum()
        assert abs(float(got / bc.count) - float(rec[b])) <= 1e-12
    empty, o = footprint_lists([])
    assert empty.tolist() == [] and o.tolist() == [0]


def _kernel_rewrite(pulled, f, ints, floats, valid, phi_flat, nx, ny):
    """The kernel's z-plane rewrite (d3q19.cuh nee_fix), read from one
    descriptor row: consumer plane z = row[1], lateral index x * ny + y
    into the flat (D, nx * ny) tables, directions row[6:6 + row[5]]."""
    axis, coord, lat_a, rho_fixed, extrap, ndirs = (int(v) for v in ints[:6])
    assert axis == 2 and lat_a == nx
    dirs = [int(i) for i in ints[6:6 + ndirs]]
    own = f[:, :, :, coord].reshape(19, nx * ny)       # lat = x * ny + y
    rho, mom = momentum(own)
    u = velocity(rho, mom)
    phi_nbr = phi(u, dirs=tuple(dirs))
    rho_star = float(floats[0]) if rho_fixed else rho
    for d, i in enumerate(dirs):
        star = phi_nbr[d] if extrap else phi_flat[d]
        val = rho_star * star + (own[i] - rho * phi_nbr[d]) * float(floats[1])
        plane = pulled[i, :, :, coord].reshape(-1)
        pulled[i, :, :, coord] = torch.where(valid[d], val, plane).reshape(
            nx, ny)
    return pulled


@pytest.mark.parametrize("kw", [CORONARY, dict(CORONARY, pulsatile=(4, 8))])
def test_z_plane_descriptor_rows(kw):
    """The collide-stream kernel's descriptor rows of the coronary: the
    x/y planes and the three z planes in boundary order, a z row with
    axis 2, the consumer plane and lat_a = nx, its tables flat over
    lateral index x * ny + y. Applying the z rows that way after the x/y
    planes gives the dense step's pulled state (every boundary in order)
    bit for bit, at a steady and at a series inlet's phases."""
    cc = compile_case(get_case("coronary", **kw))
    nx, ny, _ = cc.shape
    assert [bc.axis for bc in cc.step_bcs] == [0, 0, 2, 2, 2]
    assert [id(bc) for bc in cc.step_bcs] == [
        id(bc) for bc in cc.bcs if bc.axis != 2 or bc.window is not None]
    f = initial_f(cc)
    for t in range(3):
        f, _ = K.step_plain(f, cc, t)
    for t in (3, 6):
        ints, floats, valid, phis = K._bc_tables(cc, cc.step_bcs, t)
        pulled = pulled_state(cc, f, t, cc.kernel_bcs)
        for b, bc in enumerate(cc.step_bcs):
            assert valid[b] == bc.valid.data_ptr()
            if bc.axis != 2:
                continue
            assert tuple(ints[b, :3]) == (2, bc.consumer_coord, nx)
            assert tuple(ints[b, 6:6 + len(bc.dirs)]) == bc.dirs
            flat = bc.valid.reshape(len(bc.dirs), nx * ny)
            xs, ys = torch.meshgrid(torch.arange(nx), torch.arange(ny),
                                    indexing="ij")
            lat = (xs * ny + ys).reshape(-1)
            assert torch.equal(flat[:, lat], bc.valid.reshape(
                len(bc.dirs), -1))
            table = bc.phi_star_at(t)
            assert phis[b] == (None if table is None else table.data_ptr())
            phi_flat = None if table is None else table.reshape(
                len(bc.dirs), -1)
            pulled = _kernel_rewrite(pulled, f, ints[b], floats[b], flat,
                                     phi_flat, nx, ny)
        assert torch.equal(pulled, pulled_state(cc, f, t))


THERMAL = [("rayleigh_benard", {}), ("rayleigh_benard", dict(nx=32)),
           ("heated_cavity", {}), ("heated_cavity", dict(n=26)),
           ("heated_cavity_3d", {}), ("heated_cavity_3d", dict(n=24)),
           ("rayleigh_benard_3d", {}),
           ("rayleigh_benard_3d", dict(nx=32, ny=32, nz=18))]
TEST_SIZES = {
    "coronary": [CORONARY, dict(CORONARY, pulsatile=(4, 8)),
                 dict(shape=(64, 48, 96), radius=4, pulsatile=(4, 8)),
                 dict(shape=(32, 32, 32), radius=5)],
    "curved_vessel": [dict(n=24, nphase=4, period_steps=8),
                      dict(n=64, nphase=4, period_steps=40)],
    "pipe": [dict(n=36, curved=False)],
    "lid_driven_cavity": [dict(n=12), dict(n=64, lid="bounceback")],
    "poiseuille": [dict(n=16)],
    "gravity_channel": [dict(n=20, nz=3)],
    # built on chip_smoke's synthetic geo.txt and bc.txt (the case reads
    # its geometry from files; its defaults are the reference's)
    "bifurcation": [dict(synthetic=True)],
}


def _case_kwargs(name, kw, tmp_path):
    """The options to build `name` with: the bifurcation's synthetic files
    in place of `synthetic`, and None for its defaults where the
    reference's files are not on this machine."""
    if name != "bifurcation":
        return kw
    if kw.get("synthetic"):
        files = chip_smoke.bifurcation_inputs(str(tmp_path), surface=False)
        return dict(geo_path=files["geo"], bc_path=files["bc"])
    params = inspect.signature(bifurcation.build).parameters
    defaults = [params[k].default for k in ("geo_path", "bc_path")]
    return kw if all(os.path.exists(p) for p in defaults) else None


def _counts(boundaries):
    n_z = sum(bc.axis == 2 for bc in boundaries)
    return len(boundaries) - n_z, n_z


@pytest.mark.parametrize("name", sorted(TEST_SIZES))
def test_every_case_fits_the_descriptor_capacity(name, tmp_path):
    """Every registered case at its defaults and at the sizes the tests
    and the card run give it, the thermal boxes and the full coronary
    (291 x 291 x 372, its boundaries built without its mask) hold at
    most MAX_BCS x/y planes and MAX_Z_BCS z planes, so the collide-stream
    kernel refuses none of them for room (the coronary: 2 x planes and 3
    z planes)."""
    assert sorted(TEST_SIZES) == list_cases()
    for kw in [{}] + TEST_SIZES[name]:
        kw = _case_kwargs(name, kw, tmp_path)
        if kw is None:
            continue
        spec = get_case(name, **kw)
        n_xy, n_z = _counts(spec.boundaries)
        assert n_xy <= MAX_BCS and n_z <= MAX_Z_BCS
        check_supported(spec)
        if name == "coronary":
            assert (n_xy, n_z) == (2, 3)
    if name == "coronary":
        nx, ny, nz = coronary.REAL_SHAPE
        bw = 12 + 2
        full = coronary._boundaries(
            3, nx - 4, [nz - 3 * bw, nz - 2 * bw, nz - bw], (5, 6, 7),
            pulsatile=(40, 2000), shape=coronary.REAL_SHAPE)
        assert _counts(full) == (2, 3)
    if name == "lid_driven_cavity":
        for case, kw in THERMAL:
            spec = getattr(thermal_cases, case)(**kw)[0]
            n_xy, n_z = _counts(spec.boundaries)
            assert n_xy <= MAX_BCS and n_z <= MAX_Z_BCS
            check_supported(spec)


def test_the_capacity_is_the_kernels():
    """MAX_BCS and MAX_Z_BCS are kMaxBCs and kMaxZBCs of the kernels'
    headers (d3q19.cuh, collide_stream.cuh), and a case over either is
    refused by name, in both counts."""
    import dataclasses
    import re

    from lbm_tpu_torch.kernels import _build

    src = _build.HEADER.read_text() + (_build.CSRC / "collide_stream.cuh"
                                       ).read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kMaxBCs"], consts["kMaxZBCs"]) == (MAX_BCS, MAX_Z_BCS)
    spec = get_case("coronary", **CORONARY)
    z = [bc for bc in spec.boundaries if bc.axis == 2]
    many = dataclasses.replace(spec, boundaries=list(spec.boundaries)
                               + z * 2)
    with pytest.raises(NotImplementedError, match="9 on z planes"):
        check_supported(many)
