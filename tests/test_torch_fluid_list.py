"""The launch lists of the collide-stream kernel (the fluid-cell list, the
fp32 kernel's launch tables over the fluid cells, and the bf16 kernel's
list of aligned z pairs) and of the fused pair (x segments of (y, z)
column tiles) against brute force, and the plain versions' contract that
the kernels rely on: a step leaves every non-fluid cell as f has it, so
a kernel that stores fluid cells only agrees with its plain version given
an `out` that starts as a copy of f. On the CPU, against lbm_tpu's masks
for the same cases."""

import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine.compile import (
    LANE_IDLE,
    LANE_OUT,
    SEG,
    TILE,
    compile_case,
    compile_shard,
    fluid_cell_ids,
    fluid_launch_tables,
    fluid_pair_ids,
    live_block_ids,
    pair_interior_bits,
    live_tile_ids,
)
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.kernels import collide_stream as K

CORONARY = dict(shape=(24, 20, 32), radius=4)
CASES = [
    ("coronary", CORONARY),
    ("coronary", dict(CORONARY, pulsatile=(4, 8))),
    ("curved_vessel", dict(n=24, nphase=4, period_steps=8)),
    ("pipe", dict(n=36, curved=False)),
    ("lid_driven_cavity", dict(n=12)),
]


def brute_fluid(mask):
    flat = np.asarray(mask).reshape(-1)
    return [k for k in range(flat.size) if flat[k] == CellType.FLUID]


def brute_pairs(mask):
    """The ids (x * Y + y) * ceil(Z / 2) + z // 2 of the z pairs holding a
    fluid cell, by walking every cell."""
    mask = np.asarray(mask)
    _, ny, nz = mask.shape
    nzp = -(-nz // 2)
    return sorted({(x * ny + y) * nzp + z // 2
                   for x, y, z in zip(*np.nonzero(mask == CellType.FLUID))})


def check_pairs(mask, ids):
    """ids: fluid_pair_ids(mask) as brute force gives them, ascending
    int32, and every fluid cell in exactly one listed pair."""
    mask = np.asarray(mask)
    _, ny, nz = mask.shape
    assert ids.dtype == np.int32 and ids.tolist() == brute_pairs(mask)
    assert (np.diff(ids) > 0).all()
    row, j = np.divmod(ids.astype(np.int64), -(-nz // 2))
    cells = np.concatenate([row * nz + 2 * j,
                            (row * nz + 2 * j + 1)[2 * j + 1 < nz]])
    fluid = np.flatnonzero(mask.reshape(-1) == CellType.FLUID)
    covered, times = np.unique(cells[np.isin(cells, fluid)],
                               return_counts=True)
    assert covered.tolist() == fluid.tolist() and (times == 1).all()


def brute_interior(mask, planes):
    """The ids of the bf16 kernel's interior pairs, by walking every pair
    and its cells' 18 sources."""
    from lbm_tpu_torch.core.lattice import D3Q19

    mask = np.asarray(mask)
    nx, ny, nz = mask.shape
    nzp = -(-nz // 2)
    if nz % 2:
        return []
    out = []
    for x in range(nx):
        for y in range(ny):
            for j in range(1, nzp - 1):
                cells = [(x, y, 2 * j), (x, y, 2 * j + 1)]
                if any((axis == 2 and c // 2 == j)
                       or (axis < 2 and (x, y)[axis] == c)
                       for axis, c in planes):
                    continue
                if all(mask[c] == CellType.FLUID and not any(
                        mask[(c[0] - e[0]) % nx, (c[1] - e[1]) % ny,
                             c[2] - e[2]] in (CellType.WALL, CellType.MOVING)
                        for e in D3Q19.E[1:]) for c in cells):
                    out.append((x * ny + y) * nzp + j)
    return out


def unpack_bits(words, n):
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:n]
    return np.flatnonzero(bits).tolist()


@pytest.mark.parametrize("name,kw", [
    ("lid_driven_cavity", dict(n=16)),
    ("lid_driven_cavity", dict(n=12, lid="bounceback")),
    ("coronary", dict(CORONARY, pulsatile=(4, 8))),
    ("gravity_channel", dict(n=20, nz=3)),
    ("gravity_channel", dict(n=12, nz=10)),
])
def test_pair_interior_bits_match_brute_force(name, kw):
    """The bf16 kernel's interior pairs (one bit a pair of the box: both
    cells fluid, no wall or moving source, no z wrap, on no boundary's
    consumer plane; none with an odd nz) against a walk over every pair,
    and the case's device words the same bits."""
    spec = get_case(name, **kw)
    cc = compile_case(spec)
    planes = [(bc.axis, bc.consumer_coord) for bc in cc.bcs]
    mask = np.asarray(spec.mask)
    nx, ny, nz = mask.shape
    n_pairs = nx * ny * -(-nz // 2)
    words = pair_interior_bits(torch.from_numpy(mask.astype(np.int8)),
                               planes)
    assert words.dtype == torch.int32 and len(words) == -(-n_pairs // 32)
    want = brute_interior(mask, planes)
    assert unpack_bits(words.numpy(), n_pairs) == want
    assert unpack_bits(cc.pair_interior.numpy(), n_pairs) == want
    if nz % 2 == 0:
        assert want  # the bulk of every even-nz case here is interior


def brute_units(mask):
    """The ids of the pair's units holding a non-DEAD cell, by walking
    every cell."""
    mask = np.asarray(mask)
    g = [-(-n // t) for n, t in zip(mask.shape, TILE)]
    live = set()
    for x, y, z in zip(*np.nonzero(mask != CellType.DEAD)):
        live.add(((x // TILE[0]) * g[1] + y // TILE[1]) * g[2]
                 + z // TILE[2])
    return sorted(live)


@pytest.mark.parametrize("name,kw", CASES + [
    ("lid_driven_cavity", dict(n=16)),
    ("gravity_channel", dict(n=20, nz=3)),
])
def test_fluid_cell_ids_match_brute_force(name, kw):
    """The ascending fluid-cell ids of each case, the same cells lbm_tpu's
    mask labels FLUID, and the bf16 kernel's z pairs (an odd nz's last
    cell a pair of its own: 20x20x3); a case that launches over a list
    (the SKIP_BELOW rule of its live blocks) carries its fluid cells on
    the device; every case carries its pairs and the bf16 launch list
    (interior pairs, then the other pairs' fluid cells)."""
    spec = get_case(name, **kw)
    mask = np.asarray(spec.mask)
    np.testing.assert_array_equal(mask, np.asarray(
        ref_get_case(name, **kw).mask))
    ids = fluid_cell_ids(mask)
    assert ids.dtype == np.int32 and ids.tolist() == brute_fluid(mask)
    assert (np.diff(ids) > 0).all()
    pairs = fluid_pair_ids(mask)
    check_pairs(mask, pairs)
    cc = compile_case(spec)
    assert (cc.fluid_cells is None) == (cc.live_blocks is None)
    if cc.fluid_cells is not None:
        assert cc.fluid_cells.dtype == torch.int32
        assert cc.fluid_cells.tolist() == ids.tolist()
        assert len(ids) == int(cc.fluid.sum())
    assert cc.fluid_pairs.dtype == torch.int32
    assert cc.fluid_pairs.tolist() == pairs.tolist()
    # the bf16 launch list (every case has one): streamed, the interior
    # pairs ascending, then every other pair's fluid cells ascending;
    # else every fluid cell
    interior = brute_interior(
        mask, [(bc.axis, bc.consumer_coord) for bc in cc.bcs])
    launch, n_in = cc.pair_launch(True)
    assert launch.dtype == torch.int32
    assert launch[:n_in].tolist() == interior
    nz = mask.shape[2]
    inner = set(interior)
    rest = [c for c in ids.tolist()
            if (c // nz) * -(-nz // 2) + (c % nz) // 2 not in inner]
    assert launch[n_in:].tolist() == (rest if rest or inner else [0])
    cells, none = cc.pair_launch(False)
    assert none == 0 and cells.tolist() == (ids.tolist() or [0])


@pytest.mark.parametrize("name,kw", CASES + [
    ("gravity_channel", dict(n=20, nz=3)),
    ("poiseuille", dict(n=16)),
])
def test_unit_ids_match_brute_force(name, kw):
    """The pair's live units of each case (extents that are not multiples
    of the unit: 24x20x32, 36^3, 20x20x3) against a walk over the
    non-DEAD cells."""
    mask = np.asarray(get_case(name, **kw).mask)
    assert live_tile_ids(mask).tolist() == brute_units(mask)


@pytest.mark.parametrize("shape,share", [((130, 17, 70), 0.004),
                                         ((70, 9, 33), 0.0005),
                                         ((5, 40, 65), 0.0),
                                         ((61, 19, 45), 0.001)])
def test_lists_on_random_masks(shape, share):
    """Sparse random masks (a box with no live cell included; odd nz):
    the fluid list, the z-pair list and the unit list against brute
    force; a box without a fluid cell launches once over one non-fluid
    cell, which the kernel skips, so the step's velsum slot is still
    written."""
    rng = np.random.default_rng(7)
    draw = rng.random(shape)
    mask = np.full(shape, CellType.DEAD, np.int8)
    mask[draw < share] = CellType.FLUID
    mask[(draw >= share) & (draw < 2 * share)] = CellType.WALL
    assert fluid_cell_ids(mask).tolist() == brute_fluid(mask)
    check_pairs(mask, fluid_pair_ids(mask))
    assert live_tile_ids(mask).tolist() == brute_units(mask)
    from lbm_tpu_torch.engine.compile import _live_lists

    lists = _live_lists(mask, torch.device("cpu"))
    if share == 0.0:
        assert lists["fluid_cells"].tolist() == [0]
        assert lists["live_blocks"].tolist() == [0]
    else:
        assert lists["fluid_cells"].tolist() == brute_fluid(mask)
        assert lists["live_blocks"].tolist() == \
            live_block_ids(mask).tolist()


@pytest.mark.parametrize("world", [2, 4])
def test_shard_fluid_lists(world):
    """Each shard of the coronary split along y carries its own window's
    fluid list (one non-fluid filler cell where the window holds none)."""
    spec = get_case("coronary", shape=(32, 32, 32), radius=5)
    for rank in range(world):
        sc = compile_shard(spec, rank, world, 1)
        mask = sc.mask.numpy()
        want = brute_fluid(mask) or [0]
        if sc.fluid_cells is None:
            assert sc.live_blocks is None
            continue
        assert sc.fluid_cells.tolist() == want


def _nonfluid(cc):
    return ~cc.fluid[None].expand(19, *cc.shape)


@pytest.mark.parametrize("name,kw", CASES[:4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_step_leaves_non_fluid_cells(name, kw, dtype):
    """collide_stream, step and step2 on the CPU (their plain versions)
    write every non-fluid cell of out as f has it, bit for bit, whatever
    out held: the contract that lets the kernels store fluid cells only."""
    cc = compile_case(get_case(name, **kw))
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.uniform(0.02, 0.06, (19,) + cc.shape)
                         .astype(np.float32)).to(dtype)
    keep = _nonfluid(cc)
    series = torch.zeros(2, dtype=torch.float64)
    for launch in (
            lambda out: K.collide_stream(f, out, cc, series, 0, 5),
            lambda out: K.step(f, out, cc, series, 0, 5),
            lambda out: K.step2(f, out, cc, series, 0, 5)):
        out = torch.full_like(f, 7.0)
        try:
            launch(out)
        except ValueError:  # step2 refuses z-plane boundaries
            assert cc.z_bcs
            continue
        assert torch.equal(out[keep], f[keep])
        assert not torch.equal(out[~keep], f[~keep])


def test_pair_plain_from_a_copy_equals_two_single_steps_off_the_fluid():
    """Two plain single steps from out = f.clone() and the plain pair agree
    everywhere, the non-fluid cells included, for a vessel with walls on
    every side (the curved vessel, a series inlet)."""
    cc = compile_case(get_case("curved_vessel", n=24, nphase=4,
                               period_steps=8))
    f = torch.from_numpy(np.random.default_rng(5).uniform(
        0.02, 0.06, (19,) + cc.shape).astype(np.float32))
    series = torch.zeros(4, dtype=torch.float64)
    a, b = f.clone(), f.clone()
    K.collide_stream(f, a, cc, series, 0, 2)
    K.collide_stream(a, b, cc, series, 1, 3)
    pair = f.clone()
    K.step2(f, pair, cc, series, 2, 2)
    assert torch.equal(pair, b)
    assert series[0] == series[2] and series[1] == series[3]


# -- the fp32 kernel's launch over the fluid cells (FluidLaunch) -----------


def brute_launch(mask, moving=False, halo=None):
    """{flat cell id: (segment, lane, links, moving bits)} of every fluid
    cell, the segments' (x, y, z of lane 0) and each lane's word as the
    launch tables must hold them, by walking every cell and testing each
    direction's source label: a wall (or, moving, a moving wall) sets the
    link bit, a moving wall the moving bit; a shard's sources across its
    faces are the neighbours' rows (halo: axis, mask_lo, mask_hi)."""
    from lbm_tpu_torch.core.lattice import D3Q19

    mask = np.asarray(mask)
    nx, ny, nz = mask.shape
    ext, axis = mask, None
    if halo is not None:
        axis, lo, hi = halo
        ext = np.concatenate([np.expand_dims(np.asarray(lo), axis), mask,
                              np.expand_dims(np.asarray(hi), axis)], axis)
    stop = {int(CellType.WALL)} | ({int(CellType.MOVING)} if moving else set())
    segs, words, cells = [], [], {}
    for flat in np.flatnonzero(mask.reshape(-1) == CellType.FLUID):
        x, y, z = np.unravel_index(flat, mask.shape)
        base = flat - flat % SEG
        z0 = int(base - (x * ny + y) * nz)
        if not segs or segs[-1] != (x, y, z0):
            segs.append((int(x), int(y), z0))
            for lane in range(SEG):
                zl = z0 + lane
                words.append(LANE_OUT if not 0 <= zl < nz else
                             LANE_IDLE)
        links = mbits = 0
        for i in range(1, 19):
            src = []
            for a, (c, n) in enumerate(zip((x, y, z), (nx, ny, nz))):
                v = int(c) - int(D3Q19.E[i][a])
                src.append(v + 1 if a == axis else v % n)
            label = int(ext[tuple(src)])
            links |= (label in stop) << i
            mbits |= (moving and label == CellType.MOVING) << i
        lane = int(z - z0)
        words[(len(segs) - 1) * SEG + lane] = links
        cells[int(flat)] = (len(segs) - 1, lane, links, mbits)
    if not segs:
        segs, words = [(0, 0, 0)], [LANE_OUT] * SEG
    return segs, words, cells


def check_launch(mask, tables, moving=False, halo=None):
    """The FluidLaunch `tables` of mask against brute_launch: the same
    segments (x | y << 16, z0), sector-aligned in the flattened id and
    ascending, every fluid cell in one lane with its links (and moving
    bits), every other lane LANE_IDLE inside its row or LANE_OUT."""
    mask = np.asarray(mask)
    _, ny, nz = mask.shape
    segs, words, cells = brute_launch(mask, moving, halo)
    got = tables.segs.cpu().numpy()
    assert tables.segs.dtype == tables.links.dtype == torch.int32
    assert got[:, 0].tolist() == [x | y << 16 for x, y, _ in segs]
    assert got[:, 1].tolist() == [z0 for _, _, z0 in segs]
    assert tables.links.tolist() == words
    base = (got[:, 0] & 0xFFFF) * ny * nz + (got[:, 0] >> 16) * nz + got[:, 1]
    if cells:
        assert (base % SEG == 0).all() and (np.diff(base) >= 0).all()
    if moving:
        mwords = tables.moving.tolist()
        want = [0] * len(words)
        for seg, lane, _, mbits in cells.values():
            want[seg * SEG + lane] = mbits
        assert mwords == want
    else:
        assert tables.moving is None
    return len(cells)


@pytest.mark.parametrize("name,kw", CASES + [
    ("lid_driven_cavity", dict(n=12, lid="bounceback")),
    ("gravity_channel", dict(n=20, nz=3)),
])
def test_fluid_launch_matches_brute_force(name, kw):
    """The fp32 kernel's launch tables of each case (the coronary, also
    pulsatile, the curved vessel, the pipe, the lids, one with a moving
    lid, a z of 3 cells) against a walk over every fluid cell and its 18
    sources; the case's own tables (CompiledCase.fluid_launch) the
    same, in its moving walls' form where it has them."""
    spec = get_case(name, **kw)
    cc = compile_case(spec)
    moving = cc.wall_velocity is not None
    assert moving == (kw.get("lid") == "bounceback")
    n = check_launch(spec.mask, cc.fluid_launch, moving)
    assert n == int(cc.fluid.sum())
    assert cc.fluid_launch.nbytes == (cc.fluid_launch.segs.numel()
                                      + cc.fluid_launch.links.numel()
                                      * (2 if moving else 1)) * 4


@pytest.mark.parametrize("shape,share", [((130, 17, 70), 0.004),
                                         ((70, 9, 33), 0.02),
                                         ((5, 40, 65), 0.0),
                                         ((19, 11, 12), 0.3)])
@pytest.mark.parametrize("moving", [False, True])
def test_fluid_launch_on_random_masks(shape, share, moving):
    """Random masks (walls, moving walls, ghost and dead cells; odd nz;
    a box without a fluid cell, which launches one segment of LANE_OUT
    lanes; dense fluid whose runs cross the sector boundaries): the launch
    tables against brute force, in both forms."""
    rng = np.random.default_rng(11)
    draw = rng.random(shape)
    mask = np.full(shape, CellType.DEAD, np.int8)
    for k, label in enumerate((CellType.FLUID, CellType.WALL,
                               CellType.MOVING, CellType.GHOST)):
        mask[(draw >= k * share) & (draw < (k + 1) * share)] = label
    tables = fluid_launch_tables(torch.from_numpy(mask), moving)
    assert check_launch(mask, tables, moving) == int(
        (mask == CellType.FLUID).sum())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("axis", [0, 1])
def test_fluid_launch_of_shards(world, axis):
    """compile_shard's shards of the pulsatile coronary along x and y (the
    lid with its moving wall along y): each window's launch tables
    against brute force over its mask and the halo rows mask_lo and
    mask_hi, which set the links of its face rows."""
    for name, kw, axes in (
            ("coronary", dict(shape=(32, 32, 32), radius=5,
                              pulsatile=(4, 8)), (1,)),
            ("lid_driven_cavity", dict(n=12, lid="bounceback"), (0, 1))):
        if axis not in axes:
            continue
        spec = get_case(name, **kw)
        for rank in range(world):
            sc = compile_shard(spec, rank, world, axis)
            halo = (axis, sc.mask_lo.numpy(), sc.mask_hi.numpy())
            check_launch(sc.mask.numpy(), sc.fluid_launch,
                         sc.wall_velocity is not None, halo)


@pytest.mark.parametrize("name,kw,shard", [
    ("coronary", dict(CORONARY, pulsatile=(4, 8)), None),
    ("lid_driven_cavity", dict(n=12, lid="bounceback"), None),
    ("coronary", dict(shape=(32, 32, 32), radius=5), (1, 2)),
    ("lid_driven_cavity", dict(n=12, lid="bounceback"), (0, 4)),
])
def test_fluid_launch_pulls_the_dense_pull(name, kw, shard):
    """The pull as the list kernel makes it from the tables (each fluid
    lane's cell from its segment, direction i from its own opposite
    population where link bit i is set, + bb[i] where its moving bit is,
    else from x - e_i, or across a shard's face from the plane its
    neighbour sent) against the dense step's pull with bounce-back
    (engine/step.pulled_state without boundaries), bit for bit, on a
    random state."""
    from lbm_tpu_torch.core.lattice import D3Q19
    from lbm_tpu_torch.engine.step import halo_ext, moving_bb_terms, \
        pulled_state
    from lbm_tpu_torch.parallel.halo import ring_planes

    spec = get_case(name, **kw)
    rng = np.random.default_rng(2)
    if shard is None:
        cc = compile_case(spec)
        halo = None
    else:
        axis, world = shard
        cc = compile_shard(spec, 1, world, axis)
    f = torch.from_numpy(rng.uniform(0.02, 0.06, (19,) + cc.shape)
                         .astype(np.float32))
    nx, ny, nz = cc.shape
    src = f
    if shard is not None:
        lo, hi = (torch.from_numpy(rng.uniform(0.02, 0.06, (5,) + tuple(
            n for a, n in enumerate(cc.shape) if a != axis))
            .astype(np.float32)) for _ in range(2))
        halo = cc.halo(lo, hi)
        src = halo_ext(f, axis, lo, hi)
    want = pulled_state(cc, f, 0, bcs=[], halo=halo)
    tables = cc.fluid_launch
    words = tables.links.long()
    k = torch.nonzero((words & LANE_IDLE) == 0).reshape(-1)
    seg = tables.segs.long()[k // SEG]
    x, y, z = seg[:, 0] & 0xFFFF, seg[:, 0] >> 16, seg[:, 1] + k % SEG
    assert bool(cc.fluid[x, y, z].all()) and len(k) == int(cc.fluid.sum())
    bb = (None if cc.wall_velocity is None
          else moving_bb_terms(cc.wall_velocity))
    for i in range(19):
        ex, ey, ez = (int(v) for v in D3Q19.E[i])
        s = [x - ex, y - ey, (z - ez) % nz]
        for a, n in ((0, nx), (1, ny)):
            s[a] = s[a] + 1 if shard is not None and a == axis else s[a] % n
        pulled = src[i][s[0], s[1], s[2]]
        own = ((words[k] >> i) & 1).bool() if i else torch.zeros_like(
            k, dtype=torch.bool)
        got = torch.where(own, f[D3Q19.OPP[i]][x, y, z], pulled)
        if bb is not None:
            mv = ((tables.moving.long()[k] >> i) & 1).bool()
            got = torch.where(mv, f[D3Q19.OPP[i]][x, y, z] + float(bb[i]),
                              got)
        assert torch.equal(got, want[i][x, y, z]), i


def test_list_constants_equal_the_source():
    """SEG, LANE_IDLE and LANE_OUT against kSegLanes, kIdle and kOut in
    kernels/csrc/collide_stream_list.cuh."""
    import re
    from pathlib import Path

    src = (Path(K.__file__).parent / "csrc" / "collide_stream_list.cuh"
           ).read_text()

    def const(name):
        return int(re.search(rf"{name} = (0x[0-9a-f]+|\d+)u?;", src)
                   .group(1), 0)

    assert const("kSegLanes") == SEG
    assert const("kIdle") == LANE_IDLE
    assert const("kOut") == LANE_OUT & 0xFFFFFFFF
