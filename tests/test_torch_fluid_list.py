"""The launch lists of the collide-stream kernel (the fluid-cell list, and
the bf16 kernel's list of aligned z pairs) and of the fused pair (x
segments of (y, z) column tiles) against brute force, and the plain versions' contract that the kernels rely on: a step
leaves every non-fluid cell as f has it, so a kernel that stores fluid
cells only agrees with its plain version given an `out` that starts as a
copy of f. On the CPU, against lbm_tpu's masks for the same cases."""

import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine.compile import (
    TILE,
    compile_case,
    compile_shard,
    fluid_cell_ids,
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
