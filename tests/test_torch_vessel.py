"""The vessel path of lbm_tpu_torch on the CPU: the coronary tree (z-plane
sub-outlets, steady and pulsatile inlet) and the curved vessel, held
against lbm_tpu's Pallas kernels in interpret mode and its dense step;
the live-block list, the z windows, the series phase across chunks and
resumes, both ping-pong buffers, the spec bridge, the geometry files and
the refusals."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine import step as ref_step
from lbm_tpu.geometry import io as ref_io
from lbm_tpu.geometry.shapes import curved_pipe_mask as ref_curved_pipe_mask
from lbm_tpu.kernels.collide_stream import (
    _valid_bbox,
    make_pallas_step,
    pack_state,
    pad_spec,
    unpack_state,
)
from lbm_tpu_torch import bridge
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine import checkpoint as ckpt
from lbm_tpu_torch.engine.compile import (
    BLOCK,
    CURVED_REFUSAL,
    SKIP_BELOW,
    check_z_windows,
    compile_case,
)
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.step import fluid_speed_sum, initial_f, make_step
from lbm_tpu_torch.geometry import io
from lbm_tpu_torch.geometry.shapes import curved_pipe_mask
from lbm_tpu_torch.kernels import collide_stream as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORONARY = dict(shape=(24, 20, 32), radius=4)
PULSATILE = dict(CORONARY, pulsatile=(4, 8))
CURVED = dict(n=24, nphase=4, period_steps=8)

# (case, options, steps, make_pallas_step options)
PALLAS_CASES = {
    "coronary": ("coronary", CORONARY, 3, {}),
    "coronary_pulsatile": ("coronary", PULSATILE, 6, {}),
    "curved_vessel": ("curved_vessel", CURVED, 4, dict(tile_skip=True)),
}


def _pallas_run(name, kw, steps, pallas_kw):
    """lbm_tpu's Pallas step (interpret mode) on the padded case: the
    unpadded f after `steps` steps and the per-step velsums."""
    spec_pad = pad_spec(ref_get_case(name, **kw))
    cc_pad = ref_compile_case(spec_pad)
    step = jax.jit(make_pallas_step(cc_pad, interpret=True, **pallas_kw))
    p = pack_state(ref_step.initial_f(cc_pad),
                   jnp.asarray(np.asarray(spec_pad.mask)))
    vs = []
    for t in range(steps):
        p, v = step(p, jnp.int32(t))
        vs.append(float(np.asarray(v).sum()))
    f = np.asarray(unpack_state(p))[:, 1:-1, 1:-1, :]
    return np.ascontiguousarray(f), np.asarray(vs)


def _port_run(cc, steps, t0=0):
    """The kernel path's wrappers (their plain versions on the CPU)."""
    f = initial_f(cc)
    out = f.clone()
    series = torch.zeros(steps, dtype=torch.float64)
    for k in range(steps):
        K.step(f, out, cc, series, k, t0 + k)
        f, out = out, f
    return f, series


@pytest.mark.parametrize("which", sorted(PALLAS_CASES))
def test_kernel_path_matches_pallas(which):
    name, kw, steps, pallas_kw = PALLAS_CASES[which]
    f_ref, vs_ref = _pallas_run(name, kw, steps, pallas_kw)
    f, series = _port_run(compile_case(get_case(name, **kw)), steps)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(series.numpy(), vs_ref, rtol=1e-5)


@pytest.mark.parametrize("name,kw", [("coronary", CORONARY),
                                     ("coronary", PULSATILE),
                                     ("curved_vessel", CURVED)])
def test_dense_step_matches_reference(name, kw):
    """The dense twin takes z-plane and series boundaries through the
    same apply_bc_fixup as x/y planes: lbm_tpu's dense step, 5 steps."""
    cc = compile_case(get_case(name, **kw))
    ref = ref_compile_case(ref_get_case(name, **kw))
    np.testing.assert_array_equal(initial_f(cc).numpy(),
                                  np.asarray(ref_step.initial_f(ref)))
    f, rf = initial_f(cc), ref_step.initial_f(ref)
    st, rst = make_step(cc), jax.jit(ref_step.make_step(ref))
    for t in range(5):
        f, _, u = st(f, t)
        rf, _, ru = rst(rf, jnp.int32(t))
    np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=3e-6,
                               atol=1e-7)
    fluid = np.asarray(ref.fluid)
    np.testing.assert_allclose(
        fluid_speed_sum(cc, u).item(),
        float(np.sum(np.sqrt(np.sum(np.asarray(ru) ** 2, axis=0))[fluid])),
        rtol=1e-5)


@pytest.mark.parametrize("kw", [CORONARY, PULSATILE])
def test_fix_z_plane_plain_completes_the_dense_step(kw):
    """The x/y-only step followed by each z-plane fixup is the dense step
    with every boundary, bit for bit; the velsum corrections make the
    velsum the dense one."""
    cc = compile_case(get_case("coronary", **kw))
    assert len(cc.z_bcs) == 3 and len(cc.kernel_bcs) == 2
    f = initial_f(cc)
    dense = make_step(cc)
    for t in range(4):
        f_xy, vs = K.collide_stream_plain(f, cc, t)
        for bc in cc.z_bcs:
            vs = vs + K.fix_z_plane_plain(f, f_xy, cc, bc, t)
        f_d, _, u = dense(f, t)
        assert torch.equal(f_xy, f_d)
        assert float(vs) == pytest.approx(float(fluid_speed_sum(cc, u)),
                                          rel=1e-12)
        f = f_d


def test_live_block_ids_match_a_brute_force_count():
    rng = np.random.default_rng(7)
    mask = np.zeros((9, 10, 11), np.int32)  # 990 cells: a ragged last block
    for cell in rng.choice(mask.size, 6, replace=False):
        mask.reshape(-1)[cell] = rng.choice([-1, 1, 2, 4])
    mask.reshape(-1)[-1] = 4
    flat = mask.reshape(-1)
    want = [b for b in range(-(-flat.size // BLOCK))
            if any(flat[b * BLOCK : (b + 1) * BLOCK] != 0)]
    assert K.live_block_ids(mask).tolist() == want
    assert K.live_block_ids(mask).dtype == np.int32
    spec = get_case("coronary", shape=(64, 48, 96), radius=4)
    cc = compile_case(spec)
    flat = np.asarray(spec.mask).reshape(-1)
    want = [b for b in range(flat.size // BLOCK)
            if (flat[b * BLOCK : (b + 1) * BLOCK] != 0).any()]
    assert cc.live_blocks.tolist() == want and len(want) < SKIP_BELOW * 1152
    # the lid cavity's dead border leaves 97% of its blocks live at 64^3:
    # it keeps the full launch; at 16^3 two of its 16 blocks are dead
    assert compile_case(get_case("lid_driven_cavity", n=64)).live_blocks \
        is None
    assert compile_case(get_case("lid_driven_cavity", n=16)
                        ).live_blocks.tolist() == list(range(1, 15))


@pytest.mark.parametrize("kw", [CORONARY, dict(shape=(64, 48, 96),
                                               radius=6)])
def test_z_windows_match_lbm_tpu_valid_bbox(kw):
    cc = compile_case(get_case("coronary", **kw))
    ref = ref_compile_case(ref_get_case("coronary", **kw))
    nx, ny, _ = cc.shape
    assert [bc.window for bc in cc.bcs] == [
        _valid_bbox(r, (nx, ny)) if r.axis == 2 else None for r in ref.bcs]


def test_z_window_holding_another_boundary_is_refused():
    """No coronary z-plane consumer cell is an x/y consumer cell
    (compile_case checks); a z plane moved into the inlet's consumer
    cells is refused instead of computed wrong."""
    cc = compile_case(get_case("coronary", **CORONARY))
    check_z_windows(cc.bcs, cc.shape)
    bcs = list(cc.bcs)
    bcs[2] = dataclasses.replace(bcs[2], consumer_coord=8,
                                 window=(0, 24, 0, 20))
    with pytest.raises(ValueError, match="boundary 0 rewrites cells"):
        check_z_windows(bcs, cc.shape)


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_series_phase_follows_the_absolute_step(backend):
    """Two chunks of 3 steps give the run of one chunk of 6: the series
    phase (t // 2) % 4 comes from the absolute step, not the slot."""
    spec = get_case("coronary", **PULSATILE)
    a = Simulation(spec, device="cpu", backend=backend)
    b = Simulation(spec, device="cpu", backend=backend)
    a.run(max_steps=6, time_save=3, verbose=False)
    b.run(max_steps=6, time_save=6, verbose=False)
    assert torch.equal(a.f, b.f)
    f, _ = _port_run(a.cc, 6)
    assert torch.equal(a.f, f)


def test_both_buffers_hold_the_non_fluid_state(tmp_path):
    spec = get_case("coronary", **PULSATILE)
    sim = Simulation(spec, device="cpu")
    nonfluid = ~sim.cc.fluid

    def same():
        return torch.equal(sim.f[:, nonfluid], sim._spare[:, nonfluid])

    assert same()                                   # after reset
    sim.run(max_steps=3, time_save=3, verbose=False)
    assert same()                                   # after an odd count
    path = str(tmp_path / "c.npz")
    ckpt.save_sim(path, sim)
    sim.reset()
    sim._spare.fill_(7.0)
    ckpt.restore(sim, path)
    assert torch.equal(sim.f, sim._spare)           # after a restore


def test_resume_mid_series_matches_an_uninterrupted_run(tmp_path):
    spec = get_case("coronary", **PULSATILE)
    whole = Simulation(spec, device="cpu")
    r_whole = whole.run(max_steps=11, time_save=11, verbose=False)
    first = Simulation(spec, device="cpu")
    first.run(max_steps=5, time_save=5, verbose=False)
    path = str(tmp_path / "mid.npz")
    ckpt.save_sim(path, first)
    resumed = Simulation(spec, device="cpu")
    ckpt.restore(resumed, path)
    assert resumed.t == 5
    resumed.run(max_steps=6, time_save=3, verbose=False)
    assert resumed.t == 11 and r_whole.steps == 11
    assert torch.equal(resumed.f, whole.f)


def test_case_from_reference_carries_the_series():
    ref_spec = ref_get_case("coronary", **PULSATILE)
    spec = bridge.case_from_reference(ref_spec)
    inlet, ref_inlet = spec.boundaries[0], ref_spec.boundaries[0]
    assert inlet.u_mode == "series" and inlet.u_series_stride == 2
    np.testing.assert_array_equal(inlet.u_series, ref_inlet.u_series)
    assert inlet.u_series is not ref_inlet.u_series
    cc_a = compile_case(spec)
    cc_b = compile_case(get_case("coronary", **PULSATILE))
    fa, fb = initial_f(cc_a), initial_f(cc_b)
    for t in range(4):
        fa, _, _ = make_step(cc_a)(fa, t)
        fb, _, _ = make_step(cc_b)(fb, t)
    assert torch.equal(fa, fb)


@pytest.mark.parametrize("name,kw", [("coronary", CORONARY),
                                     ("coronary", PULSATILE),
                                     ("coronary", dict(CORONARY,
                                                       stenosis=0.5,
                                                       hyperemia=2.0)),
                                     ("curved_vessel", CURVED)])
def test_case_specs_match_reference(name, kw):
    spec, ref = get_case(name, **kw), ref_get_case(name, **kw)
    for fld in ("shape", "tau", "residual_flavor", "vtk_crops",
                "vtk_density", "stag_max", "usq_includes_outlet_labels"):
        assert getattr(spec, fld) == getattr(ref, fld), fld
    for fld in ("mask", "u0", "rho0"):
        np.testing.assert_array_equal(getattr(spec, fld), getattr(ref, fld))
    assert spec.units.C_U == ref.units.C_U
    for b, r in zip(spec.boundaries, ref.boundaries, strict=True):
        for fld in ("mask_value", "axis", "coord", "normal", "rho_mode",
                    "rho_value", "u_mode", "u_value", "u_series_stride"):
            assert getattr(b, fld) == getattr(r, fld), fld
        if r.u_series is not None:
            np.testing.assert_array_equal(b.u_series, r.u_series)


def test_curved_pipe_mask_matches_reference():
    np.testing.assert_array_equal(curved_pipe_mask(20, 22, 18, 8.0, 4.0),
                                  ref_curved_pipe_mask(20, 22, 18, 8.0, 4.0))


@pytest.mark.parametrize("order", ["xyz", "yxz"])
def test_geo_and_bc_files_round_trip(tmp_path, order):
    flag = np.random.default_rng(1).integers(0, 2, (5, 4, 3)).astype(np.int32)
    path = str(tmp_path / "geo.txt")
    io.save_geo(path, flag, order=order)
    np.testing.assert_array_equal(io.load_geo(path, (5, 4, 3), order), flag)
    np.testing.assert_array_equal(ref_io.load_geo(path, (5, 4, 3), order),
                                  flag)
    with pytest.raises(ValueError, match="entries"):
        io.load_geo(path, (5, 4, 4), order)
    bc_path = tmp_path / "bc.txt"
    vals = np.arange(2 * 5 * 3, dtype=np.float64) / 7.0
    bc_path.write_text(" ".join(f"{v:.9g}" for v in vals))
    slabs, ref_slabs = io.load_bc(str(bc_path), 5, 3), \
        ref_io.load_bc(str(bc_path), 5, 3)
    assert len(slabs) == 2 and slabs[0].shape == (5, 3)
    for a, b in zip(slabs, ref_slabs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kwargs", [
    dict(curved=True),
    dict(windkessel=[(1.0, 1.0, 1.0)] * 4),
])
def test_refuses_bouzidi_and_windkessel_by_name(kwargs):
    """Both compile; what refuses them names itself: Bouzidi walls the
    kernel backend, in lbm_tpu's words (the dense and sparse backends run
    them), windkessel outlets the fused pair of steps."""
    spec = get_case("coronary", **CORONARY, **kwargs)
    compile_case(spec)
    if "windkessel" in kwargs:
        with pytest.raises(ValueError, match="fuse=2 requires"):
            Simulation(spec, device="cpu", fuse=2)
        return
    with pytest.raises(NotImplementedError,
                       match=re.escape(CURVED_REFUSAL)):
        Simulation(spec, device="cpu")
    assert compile_case(spec).bouzidi is not None


def test_cli_runs_pulsatile_coronary(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch", "run", "--device", "cpu",
         "--case", "coronary", "--opt", "shape=[24,20,32]", "radius=4",
         "pulsatile=[4,8]", "--steps", "8", "--time-save", "4",
         "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(out)) == ["CONVERGENCE.log", "coronary_4.vtk",
                                       "coronary_8.vtk"]
    vtk = (out / "coronary_8.vtk").read_text().splitlines()
    assert vtk[4] == "DIMENSIONS 22 16 30"
    assert "SCALARS DENSITY float" in vtk
