"""The bifurcation case of lbm_tpu_torch (cases/bifurcation.py), its label
chain (geometry/mask.end_plane_copy_label), the snapshot trio of
io/snapshots.py and the L0->L7 tool (tools/l0l7_bifurcation.py) on the
CPU, held against lbm_tpu on synthetic inputs made from a seed
(chip_smoke.bifurcation_inputs: a Y bifurcation in the case's 64 x 83 x 32
box, an inlet parabola in bc.txt's layout; the reference's files are not
in the repository): the labels against lbm_tpu's and the loop
transcription of tests/test_geometry.py, the CaseSpec through the bridge,
20 dense steps against lbm_tpu's xla step, the kernel route's plain
versions against lbm_tpu's Pallas step in interpret mode for 2 steps,
the launch route (the fluid-cell list), the snapshot files byte for
byte, the tool's function at 20 steps and its refusal at its defaults,
and the CLI."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.cases.bifurcation import build_labels as ref_build_labels
from lbm_tpu.engine import step as ref_step
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.geometry.mask import end_plane_copy_label as ref_copy_label
from lbm_tpu.io import snapshots as ref_snap
from lbm_tpu.kernels.collide_stream import (
    make_pallas_step,
    pack_state,
    pad_spec,
    unpack_state,
)
from lbm_tpu_torch import bridge
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.cases.bifurcation import build_labels
from lbm_tpu_torch.cli import main as cli_main
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.spec import CaseSpec, PlaneBC
from lbm_tpu_torch.engine.step import initial_f, make_step
from lbm_tpu_torch.geometry.mask import CellType, end_plane_copy_label
from lbm_tpu_torch.geometry.preprocess import (
    extrude_open_ends,
    stl_to_occupancy,
)
from lbm_tpu_torch.io import snapshots
from lbm_tpu_torch.kernels import collide_stream as K
from lbm_tpu_torch.tools import l0l7_bifurcation
from test_geometry import _reference_geo_pre_loops

import chip_smoke


@pytest.fixture(autouse=True)
def _torch_one_thread():
    """A 170k-cell box: torch's intra-op threads would only contend with
    the other test workers' for the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The synthetic geo.txt, bc.txt and bif.stl."""
    return chip_smoke.bifurcation_inputs(
        str(tmp_path_factory.mktemp("bifurcation")))


@pytest.fixture(scope="module")
def specs(files):
    """(port spec, lbm_tpu spec) of the case on the synthetic files."""
    kw = dict(geo_path=files["geo"], bc_path=files["bc"])
    return get_case("bifurcation", **kw), ref_get_case("bifurcation", **kw)


def test_labels_match_lbm_tpu_and_the_loop_transcription():
    flag = chip_smoke.bif_occupancy()
    mask = build_labels(flag)
    np.testing.assert_array_equal(mask, ref_build_labels(flag))
    np.testing.assert_array_equal(mask, _reference_geo_pre_loops(flag))
    counts = {int(k): int(n) for k, n in zip(*np.unique(mask,
                                                        return_counts=True))}
    assert set(counts) == {-1, 0, 1, 2, 3, 4}
    assert counts[2] > 150 and counts[3] > 150
    assert chip_smoke.bif_open(mask)


def test_end_plane_copy_label_matches_lbm_tpu():
    rng = np.random.default_rng(5)
    for axis, coord, ref, target in ((1, 1, 2, 2), (1, 10, 9, 3),
                                     (0, 4, 5, 2), (2, 6, 5, 7)):
        geo = rng.integers(-1, 5, size=(12, 14, 10)).astype(np.int32)
        np.testing.assert_array_equal(
            end_plane_copy_label(geo.copy(), axis, coord, ref, target),
            ref_copy_label(geo.copy(), axis, coord, ref, target))


def _assert_same(a, b, where):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for fld in dataclasses.fields(a):
            _assert_same(getattr(a, fld.name), getattr(b, fld.name),
                         f"{where}.{fld.name}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def test_case_spec_crosses_the_bridge(specs, files):
    """lbm_tpu's spec carried across (bridge.case_from_reference, the
    inlet's u_field included) equals the port's own, field for field."""
    spec, ref = specs
    crossed = bridge.case_from_reference(ref)
    assert isinstance(crossed, CaseSpec)
    assert all(isinstance(b, PlaneBC) for b in crossed.boundaries)
    for fld in dataclasses.fields(CaseSpec):
        if fld.name != "units":
            _assert_same(getattr(crossed, fld.name), getattr(spec, fld.name),
                         fld.name)
    assert crossed.units.CH == spec.units.CH
    inlet, outlet = spec.boundaries
    assert (inlet.u_mode, inlet.rho_mode, inlet.axis, inlet.coord) == (
        "field", "extrapolate", 1, 1)
    assert (outlet.u_mode, outlet.rho_mode, outlet.coord) == (
        "extrapolate", "fixed", 81)
    assert np.isclose(inlet.u_field[1].max(), chip_smoke.BIF_INLET_PEAK)
    assert spec.residual_flavor == "usq" and spec.usq_includes_outlet_labels
    assert spec.stag_max == 10**9
    strict = get_case("bifurcation", geo_path=files["geo"],
                      bc_path=files["bc"], strict_reference=True)
    assert not strict.boundaries[0].u_field.any()


def test_dense_step_matches_lbm_tpu_xla(specs):
    """20 steps of the dense step against lbm_tpu's xla step."""
    spec, ref = specs
    cc, rcc = compile_case(spec), ref_compile_case(ref)
    f, rf = initial_f(cc), ref_step.initial_f(rcc)
    np.testing.assert_array_equal(f.numpy(), np.asarray(rf))
    st, rst = make_step(cc), jax.jit(ref_step.make_step(rcc))
    for t in range(20):
        f, _, _ = st(f, t)
        rf, _, _ = rst(rf, jnp.int32(t))
    np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=3e-6,
                               atol=1e-7)


def test_kernel_route_matches_pallas_interpret(specs):
    """The kernel route (its plain versions on the CPU: the launch over
    the fluid-cell list, with the y-plane inlet field and the fixed-rho
    outlet) against lbm_tpu's Pallas step in interpret mode, 2 steps, f
    and the velsums; the route and its literal counter name."""
    spec, ref = specs
    cc = compile_case(spec)
    assert K.launch_route(cc) == "lbm_collide_stream_list"
    assert K.counter_name(cc) == "lbm_collide_stream_list[bgk]"
    assert cc.fluid_cells is not None and not cc.z_bcs
    spec_pad = pad_spec(ref)
    cc_pad = ref_compile_case(spec_pad)
    pstep = jax.jit(make_pallas_step(cc_pad, interpret=True))
    p = pack_state(ref_step.initial_f(cc_pad),
                   jnp.asarray(np.asarray(spec_pad.mask)))
    f, out = initial_f(cc), initial_f(cc)
    series = torch.zeros(2, dtype=torch.float64)
    vs = []
    for t in range(2):
        p, v = pstep(p, jnp.int32(t))
        vs.append(float(np.asarray(v).sum()))
        K.step(f, out, cc, series, t, t)
        f, out = out, f
    f_ref = np.asarray(unpack_state(p))[:, 1:-1, 1:-1, :]
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(series.numpy(), vs, rtol=1e-5)


def test_snapshot_trio_byte_for_byte(specs, tmp_path):
    """write_live_velocities, read_midplane (of a write_midplane_fluid
    file, with and without the mask) and compare_midplane against
    lbm_tpu's, on a random u over the case's mask; a tensor u writes the
    same bytes."""
    mask = specs[0].mask
    u = np.random.default_rng(7).standard_normal(
        (3,) + mask.shape).astype(np.float32) * 0.05
    for name, ref_fn in (("live", ref_snap.write_live_velocities),
                         ("mid", ref_snap.write_midplane_fluid)):
        port_fn = getattr(snapshots, ref_fn.__name__)
        port_fn(str(tmp_path / f"{name}.port"), torch.from_numpy(u), mask)
        ref_fn(str(tmp_path / f"{name}.ref"), u, mask)
        assert ((tmp_path / f"{name}.port").read_bytes()
                == (tmp_path / f"{name}.ref").read_bytes())
    mid = str(tmp_path / "mid.port")
    for m in (None, mask):
        got = snapshots.read_midplane(mid, mask.shape[:2], mask=m)
        np.testing.assert_array_equal(
            got, ref_snap.read_midplane(mid, mask.shape[:2], mask=m))
    fluid = mask[:, :, mask.shape[2] // 2] == CellType.FLUID
    comp = got + 0.01 * np.random.default_rng(8).standard_normal(got.shape)
    for fl in (fluid, None):
        assert (snapshots.compare_midplane(got, torch.from_numpy(comp), fl)
                == ref_snap.compare_midplane(got, comp, fl))
    with pytest.raises(ValueError, match="expected 2x64x83"):
        snapshots.read_midplane(str(tmp_path / "live.port"), (64, 83))


def test_l0l7_runs_on_the_cpu(files):
    """The tool's function on the synthetic STL (voxelized back at spacing
    1, its inlet reaching its outlet), the synthetic "shipped" geo.txt
    and bc.txt, 20 steps a run on the kernel route's plain versions: both
    runs finite and bounded, the two geometries' cell counts close, the
    midplane stats and the 3D ratio."""
    self_flag = extrude_open_ends(stl_to_occupancy(
        files["stl"], chip_smoke.BIF_SHAPE, spacing=1.0), axis=1)
    assert chip_smoke.bif_open(build_labels(self_flag))
    lines = []
    out = l0l7_bifurcation.l0l7(files["stl"], files["geo"], files["bc"],
                                steps=20, spacing=1.0, device="cpu",
                                log=lines.append)
    for tag in ("shipped-geo", "self-voxelized"):
        run = out[tag]
        assert run["steps"] == 20 and run["finite"]
        assert run["u_max"] <= 3 * run["inlet_peak"]
        assert run["inlet"] > 150 and run["outlet"] > 150
    a, b = out["shipped-geo"]["nlattice"], out["self-voxelized"]["nlattice"]
    # the surface, rasterized at 3/4 of the box's resolution and smoothed,
    # comes back 13% larger (33,434 non-DEAD cells against 29,594)
    assert abs(a - b) / a < 0.2
    stats = out["compare_midplane"]
    assert stats["n"] == 2 * out["midplane"]["common"] > 2000
    assert 0 < stats["l2_rel"] < 1 and stats["corr"] > 0.5
    assert np.isfinite(out["ratio_3d"])
    assert lines[-1].startswith("3D common-fluid |du|max/|u|max = ")


def test_l0l7_refuses_a_missing_file(files, capsys, tmp_path):
    """At its defaults (the reference's files, not in this repository) the
    tool exits 1 naming the missing file; so does its function."""
    args = []
    if os.path.isdir(l0l7_bifurcation.REFERENCE):
        args = ["--stl", str(tmp_path / "bif.stl")]
    assert l0l7_bifurcation.main(args) == 1
    err = capsys.readouterr().err
    assert "l0l7_bifurcation: no such file: " in err and "bif.stl" in err
    with pytest.raises(FileNotFoundError, match="no-geo.txt"):
        l0l7_bifurcation.l0l7(files["stl"], str(tmp_path / "no-geo.txt"),
                              files["bc"], steps=1, device="cpu")


def test_cli_runs_the_case_with_snapshots(files, tmp_path, capsys):
    out = tmp_path / "out"
    rc = cli_main(["run", "--device", "cpu", "--case", "bifurcation",
                   "--opt", f"geo_path={files['geo']}",
                   f"bc_path={files['bc']}", "--steps", "8", "--time-save",
                   "4", "--snapshots", "--out", str(out)])
    assert rc == 0, capsys.readouterr()
    names = set(os.listdir(out))
    assert {"meas1.txt", "s1_out.txt", "vel.csv",
            "CONVERGENCE.log"} <= names
    assert any(n.endswith(".vtk") for n in names)
    mid = snapshots.read_midplane(str(out / "meas1.txt"), (64, 83))
    assert np.isfinite(mid).all() and np.abs(mid).max() > 0
