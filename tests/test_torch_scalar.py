"""The dense scalar-transport port (lbm_tpu_torch/engine/scalar.py) held
against lbm_tpu/engine/scalar.py on the CPU: the tables, the frozen-field
ScalarTransport on a closed box, a poiseuille wash-in with div_fix, a
bolus gate and a small coronary in mean-age mode, the dense
CoupledTransport on a small pulsatile coronary, the bridge, and the CLI.

Inputs are made with numpy from a seed (or by lbm_tpu's own flow run) and
go through both packages. Tolerances: the port multiplies by the fp32
1/tau_g where lbm_tpu's dense pass divides by tau_g (the port keeps the
form of lbm_tpu's Pallas kernel), one ulp a step apart, so c of order 1
is held at atol 2e-6 (5e-5 where c reaches 25)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.core.units import UnitSystem as RefUnits
from lbm_tpu.engine import scalar as ref_scalar
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.engine.spec import CaseSpec as RefCaseSpec
from lbm_tpu_torch import bridge
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine import scalar as S
from lbm_tpu_torch.engine.scalar import CoupledTransport, ScalarTransport
from lbm_tpu_torch.geometry.mask import CellType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORONARY = dict(shape=(24, 20, 32), radius=4)


def _closed_box(n):
    mask = np.full((n, n, n), int(CellType.WALL), np.int32)
    mask[1:-1, 1:-1, 1:-1] = int(CellType.FLUID)
    return RefCaseSpec(name="box", shape=(n, n, n), tau=0.6,
                       units=RefUnits(CH=1e-4, C_U=1.0), mask=mask,
                       boundaries=[])


def _random_u(spec, seed, scale=0.04):
    """A seeded random velocity, zero off the fluid cells."""
    rng = np.random.default_rng(seed)
    u = (scale * rng.standard_normal((3,) + tuple(spec.shape))).astype(
        np.float32)
    u[:, np.asarray(spec.mask) != CellType.FLUID] = 0.0
    return u


def _flow_u(name, steps, **kw):
    """The velocity lbm_tpu's dense flow reaches after `steps` steps."""
    spec = ref_get_case(name, **kw)
    sim = RefSimulation(spec, backend="xla")
    sim.run(max_steps=steps, time_save=steps, verbose=False)
    return spec, np.asarray(sim.macro()[1])


def _assert_fields(ref, port, atol):
    np.testing.assert_allclose(port.concentration().numpy(),
                               np.asarray(ref.concentration()), atol=atol)
    np.testing.assert_allclose(port.total(), ref.total(), rtol=1e-5,
                               atol=1e-6)


def test_tables_equal_lbm_tpu():
    """phi7, _defect, bc_geometry and dirichlet_walls against lbm_tpu's on
    the small coronary: equal bit for bit (the same fp32 expressions)."""
    rspec = ref_get_case("coronary", **CORONARY)
    spec = bridge.case_from_reference(rspec)
    u = _random_u(spec, 1)
    nbr, axes = S.blocking_tables(spec.mask)
    up = S.project(torch.from_numpy(u), torch.from_numpy(axes))
    rup = ref_scalar._project(jnp.asarray(u), jnp.asarray(axes))
    assert np.array_equal(up.numpy(), np.asarray(rup))
    assert np.array_equal(S.phi7(up).numpy(), np.asarray(ref_scalar.phi7(rup)))
    sc = S.compile_scalar(spec, "cpu", D=0.02)
    rgeo = ref_scalar.bc_geometry(rspec)
    assert len(sc.bcs) == len(rgeo) == 5
    for bc, (d, axis, sign, sl, plane) in zip(sc.bcs, rgeo):
        assert (bc.dir, bc.axis, bc.sign) == (d, axis, sign)
        assert sl[axis] == bc.coord
        assert np.array_equal(bc.valid.numpy(), np.asarray(plane))
        assert bc.count == int(np.asarray(plane).sum())
    d = S.defect(up, torch.from_numpy(nbr), sc.bcs)
    rd = ref_scalar._defect(rup, jnp.asarray(nbr), rgeo)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), atol=1e-9)
    wall_c = np.full(spec.shape, np.nan, np.float32)
    walls = np.asarray(spec.mask) == CellType.WALL
    wall_c[walls] = np.linspace(-1, 1, int(walls.sum()), dtype=np.float32)
    for got, want in zip(S.dirichlet_walls(spec.mask, wall_c),
                         ref_scalar.dirichlet_walls(rspec.mask, wall_c)):
        assert np.array_equal(got, np.asarray(want))
    assert S.tau_g_of(0.02) == ref_scalar.tau_g_of(0.02)


def test_closed_box_matches_lbm_tpu_and_conserves():
    """Bounce-back diffusion and advection in a random u, no boundary
    planes, Dirichlet values on one wall: c at atol 2e-6; without the
    Dirichlet wall the total is conserved."""
    rspec = _closed_box(12)
    spec = bridge.case_from_reference(rspec)
    u = _random_u(spec, 0)
    x = np.arange(12) - 5.5
    c0 = np.exp(-(x[:, None, None] ** 2 + x[None, :, None] ** 2
                  + x[None, None, :] ** 2) / 8.0).astype(np.float32)
    ref = ref_scalar.ScalarTransport(rspec, u, D=0.02, c0=c0, div_fix=False)
    port = ScalarTransport(spec, u, D=0.02, c0=c0, div_fix=False,
                           device="cpu")
    tot0 = port.total()
    ref.run(8)
    assert port.run(8) is None
    _assert_fields(ref, port, 2e-6)
    np.testing.assert_allclose(port.total(), tot0, rtol=1e-5)
    wall_c = np.full(spec.shape, np.nan, np.float32)
    wall_c[0] = 0.5
    ref = ref_scalar.ScalarTransport(rspec, u, D=0.02, c0=c0, div_fix=False,
                                     wall_c=wall_c)
    port = ScalarTransport(spec, u, D=0.02, c0=c0, div_fix=False,
                           wall_c=wall_c, device="cpu", backend="dense")
    ref.run(8)
    port.run(8)
    _assert_fields(ref, port, 2e-6)


def test_poiseuille_washin_with_div_fix_matches_lbm_tpu():
    """x/y boundary planes, a steady inlet c = 1, zero-gradient outlet,
    div_fix on: the field and both record series at atol 2e-6."""
    rspec, u = _flow_u("poiseuille", 100, n=16)
    spec = bridge.case_from_reference(rspec)
    ref = ref_scalar.ScalarTransport(rspec, u, D=0.02, inlet_c={0: 1.0})
    port = ScalarTransport(spec, u, D=0.02, inlet_c={0: 1.0}, device="cpu")
    assert port.sc.comp is not None
    sr = ref.run(40, record=[0, 1])
    sp = port.run(40, record=[0, 1])
    assert sp.shape == (40, 2) and sp[-1, 0] > 0.9
    np.testing.assert_allclose(sp, sr, atol=2e-6)
    _assert_fields(ref, port, 2e-6)


def test_bolus_gate_matches_lbm_tpu():
    """A time-gated inlet: lbm_tpu's traced jnp.where gate and the port's
    host callable of the integer step line up step for step, across two
    runs (the step count carries over)."""
    rspec, u = _flow_u("poiseuille", 100, n=16)
    spec = bridge.case_from_reference(rspec)
    ref = ref_scalar.ScalarTransport(
        rspec, u, D=0.03, inlet_c={0: lambda t: jnp.where(t < 10, 1.0, 0.0)},
        div_fix=False)
    port = ScalarTransport(
        spec, u, D=0.03, inlet_c={0: lambda t: 1.0 if t < 10 else 0.0},
        div_fix=False, device="cpu")
    sr = np.concatenate([ref.run(6, record=[0, 1]),
                         ref.run(24, record=[0, 1])])
    sp = np.concatenate([port.run(6, record=[0, 1]),
                         port.run(24, record=[0, 1])])
    assert port.t == 30 and sp[:, 0].argmax() < 10 < 29
    np.testing.assert_allclose(sp, sr, atol=2e-6)
    _assert_fields(ref, port, 2e-6)


def test_coronary_mean_age_matches_lbm_tpu():
    """The z-plane multi-outlet tree in mean-age mode (source = 1, inlet
    age 0), every outlet recorded; c reaches 25, so atol 5e-5."""
    rspec, u = _flow_u("coronary", 100, **CORONARY)
    spec = bridge.case_from_reference(rspec)
    outlets = list(range(1, len(spec.boundaries)))
    ref = ref_scalar.ScalarTransport(rspec, u, D=0.02, inlet_c={0: 0.0},
                                     source=1.0)
    port = ScalarTransport(spec, u, D=0.02, inlet_c={0: 0.0}, source=1.0,
                           device="cpu")
    assert port.sc.cells is not None
    sr = ref.run(25, record=outlets)
    sp = port.run(25, record=outlets)
    np.testing.assert_allclose(sp, sr, atol=5e-5)
    _assert_fields(ref, port, 5e-5)
    assert float(port.concentration().max()) > 20


@pytest.mark.parametrize("div_fix", [True, False])
def test_coupled_dense_matches_lbm_tpu(div_fix):
    """The dense CoupledTransport on a small pulsatile coronary: flow and
    scalar together, the scalar in each step's in-step velocity; f at
    rtol 3e-6, c and the series at atol 2e-6; then lbm_tpu's state is
    carried across the bridge and both step 16 more."""
    kw = dict(CORONARY, pulsatile=(4, 8))
    rspec = ref_get_case("coronary", **kw)
    spec = get_case("coronary", **kw)
    rec = list(range(len(spec.boundaries)))
    ref = ref_scalar.CoupledTransport(rspec, D=0.02, inlet_c={0: 1.0},
                                      div_fix=div_fix)
    port = CoupledTransport(spec, D=0.02, inlet_c={0: 1.0}, div_fix=div_fix,
                            device="cpu", backend="dense")
    sr = ref.run(16, record=rec)
    sp = port.run(16, record=rec)
    np.testing.assert_allclose(sp, sr, atol=2e-6)
    np.testing.assert_allclose(port.f.numpy(), np.asarray(ref.f), rtol=3e-6,
                               atol=1e-7)
    _assert_fields(ref, port, 2e-6)
    assert float(port.concentration().max()) > 0.5
    # the dense (7, X, Y, Z) and (19, X, Y, Z) states cross the bridge
    carried = CoupledTransport(
        spec, inlet_c={0: 1.0}, div_fix=div_fix, device="cpu",
        backend="dense", **bridge.transport_kwargs_from_reference(ref))
    bridge.load_transport_state(carried,
                                bridge.transport_state_from_reference(ref))
    sr = ref.run(16, record=rec)
    sp = carried.run(16, record=rec)
    assert carried.t == 32
    np.testing.assert_allclose(sp, sr, atol=2e-6)
    _assert_fields(ref, carried, 2e-6)


def test_coupled_kernel_route_tracks_the_dense_route():
    """The kernel route (its plain versions here) advects in (m' - F/2) /
    rho of the post-collision state, the dense route in the in-step
    velocity: equal in exact arithmetic, held at lbm_tpu's own tolerance
    between its two routes (rtol 2e-5 of the field's scale)."""
    spec = get_case("coronary", **dict(CORONARY, pulsatile=(4, 8)))
    rec = [0, 1]
    dense = CoupledTransport(spec, D=0.02, inlet_c={0: 1.0}, div_fix=False,
                             device="cpu", backend="dense")
    kern = CoupledTransport(spec, D=0.02, inlet_c={0: 1.0}, device="cpu")
    sd, sk = dense.run(16, record=rec), kern.run(16, record=rec)
    assert torch.equal(dense.f, kern.f)
    scale = float(dense.concentration().abs().max())
    np.testing.assert_allclose(kern.concentration().numpy(),
                               dense.concentration().numpy(), rtol=2e-5,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(sk, sd, rtol=2e-5, atol=2e-5 * scale)
    rho, u = kern.macro()
    rho_d, u_d = dense.macro()
    assert torch.equal(rho, rho_d) and torch.equal(u, u_d)


def test_arguments_are_checked():
    spec = get_case("poiseuille", n=12)
    u = np.zeros((3,) + tuple(spec.shape), np.float32)
    with pytest.raises(ValueError, match="exactly one of D"):
        ScalarTransport(spec, u, device="cpu")
    with pytest.raises(ValueError, match="tau_g must exceed"):
        ScalarTransport(spec, u, tau_g=0.4, device="cpu")
    with pytest.raises(ValueError, match="absent boundaries"):
        ScalarTransport(spec, u, D=0.02, inlet_c={7: 1.0}, device="cpu")
    with pytest.raises(ValueError, match=r"u shape"):
        ScalarTransport(spec, u[:, 1:], D=0.02, device="cpu")
    with pytest.raises(ValueError, match="backend must be"):
        ScalarTransport(spec, u, D=0.02, device="cpu", backend="pallas")
    wall_c = np.full(spec.shape, np.nan, np.float32)
    wall_c[np.asarray(spec.mask) == CellType.FLUID] = 1.0
    with pytest.raises(ValueError, match="non-wall"):
        ScalarTransport(spec, u, D=0.02, wall_c=wall_c, device="cpu")
    with pytest.raises(ValueError, match="no div_fix"):
        CoupledTransport(spec, D=0.02, div_fix=True, device="cpu")
    st = ScalarTransport(spec, u, D=0.02, device="cpu")
    with pytest.raises(ValueError, match="record names absent"):
        st.run(1, record=[5])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ScalarTransport(spec, u, D=0.02)


def test_coupled_refuses_windkessel_outlets():
    """Windkessel outlets run in CoupledTransport
    (tests/test_torch_windkessel.py) but not beside a force field: the
    refusal is lbm_tpu's runtime-force step's."""
    from lbm_tpu_torch.kernels.collide_stream import ForceField

    wk = [(1e-4, 5e3, 2e-3)] * 4
    spec = get_case("coronary", shape=(48, 24, 40), radius=5, windkessel=wk)
    for backend in ("kernel", "dense"):
        with pytest.raises(ValueError, match="runtime-force step"):
            CoupledTransport(spec, D=0.02, device="cpu", backend=backend,
                             field=ForceField((0.0, 0.0, 1e-5)))


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_bridge_carries_a_frozen_transport(backend):
    """A lbm_tpu ScalarTransport's state and arguments carried into the
    port after 10 steps and stepped 10 more in each package."""
    rspec, u = _flow_u("coronary", 60, **CORONARY)
    gate = 12
    ref = ref_scalar.ScalarTransport(
        rspec, u, D=0.02,
        inlet_c={0: lambda t: jnp.where(t < gate, 1.0, 0.0)})
    ref.run(10)
    kw = bridge.transport_kwargs_from_reference(ref, u=u)
    assert kw["tau_g"] == ref.tau_g and kw["u"].dtype == np.float32
    port = ScalarTransport(
        bridge.case_from_reference(rspec), device="cpu", backend=backend,
        inlet_c={0: lambda t: 1.0 if t < gate else 0.0}, **kw)
    state = bridge.transport_state_from_reference(ref)
    assert state["f"] is None and state["g"].shape == (7,) + rspec.shape
    bridge.load_transport_state(port, state)
    assert port.t == 10
    sr = ref.run(10, record=[0])
    sp = port.run(10, record=[0])
    np.testing.assert_allclose(sp, sr, atol=2e-6)
    _assert_fields(ref, port, 2e-6)


def test_cli_transport_writes_the_washout_files(tmp_path):
    """`transport` on the CPU: the frozen route with a bolus and --vtk,
    and the coupled route, write <case>_washout.csv with one row a step
    and one column a boundary."""
    common = [sys.executable, "-m", "lbm_tpu_torch", "transport", "--device",
              "cpu", "--case", "coronary"]
    runs = (
        (["--flow-steps", "10", "--steps", "12", "--bolus", "5", "--vtk",
          "--opt", "shape=[24,20,32]", "radius=4"],
         ["coronary_c_12.vtk", "coronary_washout.csv"], 12),
        (["--coupled", "--steps", "8", "--opt", "shape=[24,20,32]",
          "radius=4", "pulsatile=[4,8]"], ["coronary_washout.csv"], 8),
    )
    for k, (args, want, steps) in enumerate(runs):
        out = tmp_path / f"run{k}"
        proc = subprocess.run(common + ["--out", str(out)] + args, cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert sorted(os.listdir(out)) == want
        with open(out / "coronary_washout.csv") as fh:
            head = fh.readline().strip()
        assert head == "step,bc0,bc1,bc2,bc3,bc4"
        series = np.loadtxt(out / "coronary_washout.csv", delimiter=",",
                            skiprows=1)
        assert series.shape == (steps, 5) and np.isfinite(series).all()
        assert series[:, 0].max() > 0.3
        assert "bc0: peak" in proc.stdout
