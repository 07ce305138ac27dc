"""The fused pair of steps (Simulation(fuse=2), kernels.step2 and its
plain version, the live-tile list, the refusals) held against lbm_tpu on
the CPU: its Pallas fuse=2 runner in interpret mode and its dense step."""

import os

import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine.compile import (
    TILE,
    compile_case,
    fuse2_refusal,
    live_tile_ids,
)
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.kernels import collide_stream as K

X_Y_PLANES = "fuse=2 requires a single-chip run with all NEE boundaries on x/y planes"
FUSE1_ONLY = "only wired on the single-call fuse=1 path"


def test_fuse2_runner_matches_lbm_tpu_pallas_fuse2():
    """One pair and one odd tail step (max_steps=3 in one chunk) against
    lbm_tpu's Pallas fuse=2 runner in interpret mode."""
    kw = dict(n=16, max_steps=3, time_save=3)
    ref = RefSimulation(ref_get_case("lid_driven_cavity", **kw),
                        backend="pallas", fuse=2)
    assert ref._fuse2
    r_ref = ref.run(verbose=False)
    sim = Simulation(get_case("lid_driven_cavity", **kw), device="cpu",
                     fuse=2)
    res = sim.run(verbose=False)
    assert res.steps == r_ref.steps == 3
    np.testing.assert_allclose(sim.f_standard().numpy(),
                               np.asarray(ref.f_standard()), rtol=3e-6,
                               atol=1e-7)
    assert abs(res.residual - r_ref.residual) < 1e-6


@pytest.mark.parametrize("steps", [4, 5])
def test_fuse2_series_inlet_matches_lbm_tpu_dense(steps):
    """The pulsatile curved vessel (a series inlet whose phase moves
    every two steps) through fuse=2 pairs in chunks of 3 steps (a pair and
    an odd tail step, so later pairs start at odd steps), against
    lbm_tpu's dense step; the usq residual of the last chunk too."""
    kw = dict(n=24, nphase=4, period_steps=8)
    ref = RefSimulation(ref_get_case("curved_vessel", **kw), backend="xla")
    r_ref = ref.run(max_steps=steps, time_save=3, verbose=False)
    sim = Simulation(get_case("curved_vessel", **kw), device="cpu", fuse=2)
    res = sim.run(max_steps=steps, time_save=3, verbose=False)
    assert sim.t == steps
    np.testing.assert_allclose(sim.f_standard().numpy(),
                               np.asarray(ref.f_standard()), rtol=3e-6,
                               atol=1e-7)
    # usq residuals early in a run are ratios of small differences:
    # held at the velsum tolerance, relative
    assert np.isfinite(res.residual)
    assert res.residual == pytest.approx(r_ref.residual, rel=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("curved_vessel", dict(n=16, nphase=4, period_steps=4)),
    ("lid_driven_cavity", dict(n=12, collision="trt", lid="bounceback")),
    ("gravity_channel", dict(n=10, nz=3, collision="trt")),
])
def test_pair_plain_is_two_single_steps(name, kw):
    """collide_stream2_plain against two step_plain calls at t and t + 1,
    bit for bit, and step2 on the CPU writes both velsums."""
    cc = compile_case(get_case(name, **kw))
    f = torch.from_numpy(np.random.default_rng(0).uniform(
        0.02, 0.06, (19,) + cc.shape).astype(np.float32))
    t = 3
    f1, v1 = K.step_plain(f, cc, t)
    f2, v2 = K.step_plain(f1, cc, t + 1)
    g, w1, w2 = K.collide_stream2_plain(f, cc, t)
    assert torch.equal(g, f2)
    assert float(w1) == float(v1) and float(w2) == float(v2)
    out = torch.empty_like(f)
    series = torch.zeros(3, dtype=torch.float64)
    K.step2(f, out, cc, series, 1, t)
    assert torch.equal(out, f2)
    assert series.tolist() == [0.0, float(v1), float(v2)]


@pytest.mark.parametrize("shape", [(24, 20, 32), (13, 9, 30), (5, 17, 3),
                                   (130, 17, 70)])
def test_live_tile_ids_match_a_brute_force_count(shape):
    """The ids of the pair's units, x segments of TILE[0] planes of
    TILE[1] x TILE[2] (y, z) column tiles (ceil-div, z fastest), whose
    cells inside the box include a non-DEAD one."""
    rng = np.random.default_rng(1)
    mask = np.where(rng.random(shape) < 0.02, CellType.FLUID,
                    CellType.DEAD).astype(np.int32)
    g = [-(-n // t) for n, t in zip(shape, TILE)]
    sx, sy, sz = TILE
    want = []
    for tx in range(g[0]):
        for ty in range(g[1]):
            for tz in range(g[2]):
                blk = mask[tx * sx:(tx + 1) * sx, ty * sy:(ty + 1) * sy,
                           tz * sz:(tz + 1) * sz]
                if (blk != CellType.DEAD).any():
                    want.append((tx * g[1] + ty) * g[2] + tz)
    got = live_tile_ids(mask)
    assert got.dtype == np.int32 and got.tolist() == want
    cor = compile_case(get_case("coronary", shape=(24, 20, 32), radius=4))
    assert cor.live_tiles.tolist() == live_tile_ids(
        np.asarray(cor.spec.mask)).tolist()
    assert compile_case(get_case("lid_driven_cavity", n=16)).live_tiles \
        is None


def test_refusals_in_lbm_tpus_words():
    """fuse=2 refuses z-plane boundaries (the coronary's sub-outlets) and
    lowmem in lbm_tpu's words, and the dense backend, which has no pair."""
    cor = dict(shape=(24, 20, 32), radius=4)
    with pytest.raises(ValueError, match=X_Y_PLANES):
        RefSimulation(ref_get_case("coronary", **cor), backend="pallas",
                      fuse=2)
    with pytest.raises(ValueError, match=X_Y_PLANES):
        Simulation(get_case("coronary", **cor), device="cpu", fuse=2)
    assert fuse2_refusal(get_case("coronary", **cor)) == X_Y_PLANES
    ref = RefSimulation(ref_get_case("lid_driven_cavity", n=8),
                        backend="pallas", fuse=2, lowmem=True)
    with pytest.raises(ValueError, match=FUSE1_ONLY):
        ref.run(max_steps=2, time_save=2, verbose=False)
    with pytest.raises(ValueError, match=FUSE1_ONLY):
        Simulation(get_case("lid_driven_cavity", n=8), device="cpu",
                   fuse=2, lowmem=True)
    with pytest.raises(ValueError, match="backend='dense'"):
        Simulation(get_case("lid_driven_cavity", n=8), device="cpu",
                   backend="dense", fuse=2)
    with pytest.raises(ValueError, match="fuse must be 1 or 2"):
        Simulation(get_case("lid_driven_cavity", n=8), device="cpu", fuse=3)
    cc = compile_case(get_case("coronary", **cor))
    f = torch.zeros((19,) + cc.shape)
    with pytest.raises(ValueError, match=X_Y_PLANES):
        K.step2(f, f.clone(), cc, torch.zeros(2, dtype=torch.float64), 0, 0)


def test_cli_run_fuse2(tmp_path):
    from lbm_tpu_torch.cli import main

    out = str(tmp_path / "lid")
    assert main(["run", "--device", "cpu", "--case", "lid_driven_cavity",
                 "--opt", "n=12", "--steps", "7", "--time-save", "7",
                 "--fuse", "2", "--out", out]) == 0
    files = sorted(os.listdir(out))
    assert "CONVERGENCE.log" in files and "lid_driven_cavity_7.vtk" in files
