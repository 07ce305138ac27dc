"""The yardstick's byte counts against counts made by hand on small
masks."""

from __future__ import annotations

import numpy as np

from lbm_bench import yardstick
from lbm_bench.reference.geometry import Geometry, Plane, build
from lbm_bench.reference.lattice import FLUID, INLET, WALL


def _geom(mask, planes=(), residual="velsum"):
    shape = mask.shape
    return Geometry(shape=shape, mask=mask.astype(np.int32),
                    u0=np.zeros((3,) + shape, np.float32), tau=0.6,
                    planes=list(planes), residual=residual)


def test_periodic_fluid_box_moves_153_bytes_a_cell():
    # every population pulled once (19 x 4 B), written once (19 x 4 B),
    # one label byte
    g = _geom(np.full((3, 4, 5), FLUID))
    assert yardstick.step_bytes(g) == 60 * (19 * 4 + 19 * 4 + 1)


def test_lone_fluid_cell_in_walls_reads_its_own_opposites():
    mask = np.full((3, 3, 3), WALL)
    mask[1, 1, 1] = FLUID
    # 18 opposites off the walls and its rest population: 19 reads
    assert yardstick.step_bytes(_geom(mask)) == 19 * 4 + 19 * 4 + 1


def test_plane_rewrite_reads_its_cells_and_tables():
    # a 1-cell-wide column along y: walls around, a fixed-velocity plane
    # at y = 0 feeding y = 1; fluid y = 1..3, periodic in y
    mask = np.full((3, 4, 3), WALL)
    mask[1, 1:, 1] = FLUID
    mask[1, 0, 1] = INLET
    p = Plane(label=INLET, axis=1, coord=0, normal=1, u="fixed")
    g = _geom(mask, [p])
    # 3 fluid cells, each pulling 19 populations: 57 (population, cell)
    # reads, among them the plane cell's (1, 0, 1) +y population; the
    # rewritten cell (1, 1, 1) reads all 19 of its own, and only its -y
    # one is pulled by no fluid cell: 58; written 3 x 77; the table: one
    # cell x 5 directions x (valid byte + phi* float)
    assert yardstick.step_bytes(g) == 58 * 4 + 3 * 77 + 1 * 5 * 5


def test_windkessel_prime_bytes():
    wk = [[2e-4, 2e4, 1e-3]] + [[2e-4, 2e4, 3e-3]] * 3
    g = build("coronary", {"shape": [40, 24, 48], "radius": 4,
                           "windkessel": wk})
    n = sum(int((np.take(g.mask, p.coord, axis=p.axis) == p.label).sum())
            for p in g.planes if p.windkessel is not None)
    assert n > 0
    assert yardstick.wk_flux_bytes(g) == n * (19 * 4 + 12) + 4 * 4
    per_step = yardstick.bytes_per_step(g, 10)
    assert per_step == (yardstick.step_bytes(g)
                        + (yardstick.wk_flux_bytes(g)
                           + yardstick.usq_bytes(g)) / 10)
