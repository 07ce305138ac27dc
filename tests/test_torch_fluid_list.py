"""The launch lists of the collide-stream kernel (the fluid-cell list) and
of the fused pair (x segments of (y, z) column tiles) against brute
force, and the plain versions' contract that the kernels rely on: a step
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
    live_block_ids,
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


@pytest.mark.parametrize("name,kw", CASES)
def test_fluid_cell_ids_match_brute_force(name, kw):
    """The ascending fluid-cell ids of each case, the same cells lbm_tpu's
    mask labels FLUID; a case that launches over a list (the SKIP_BELOW
    rule of its live blocks) carries them on the device, the others
    none."""
    spec = get_case(name, **kw)
    mask = np.asarray(spec.mask)
    np.testing.assert_array_equal(mask, np.asarray(
        ref_get_case(name, **kw).mask))
    ids = fluid_cell_ids(mask)
    assert ids.dtype == np.int32 and ids.tolist() == brute_fluid(mask)
    assert (np.diff(ids) > 0).all()
    cc = compile_case(spec)
    assert (cc.fluid_cells is None) == (cc.live_blocks is None)
    if cc.fluid_cells is not None:
        assert cc.fluid_cells.dtype == torch.int32
        assert cc.fluid_cells.tolist() == ids.tolist()
        assert len(ids) == int(cc.fluid.sum())


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
                                         ((5, 40, 65), 0.0)])
def test_lists_on_random_masks(shape, share):
    """Sparse random masks (a box with no live cell included): the fluid
    list and the unit list against brute force; a box without a fluid
    cell launches once over one non-fluid cell, which the kernel skips,
    so the step's velsum slot is still written."""
    rng = np.random.default_rng(7)
    draw = rng.random(shape)
    mask = np.full(shape, CellType.DEAD, np.int8)
    mask[draw < share] = CellType.FLUID
    mask[(draw >= share) & (draw < 2 * share)] = CellType.WALL
    assert fluid_cell_ids(mask).tolist() == brute_fluid(mask)
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
