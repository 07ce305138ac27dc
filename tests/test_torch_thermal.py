"""The Boussinesq thermal port (lbm_tpu_torch/engine/thermal.py, the
force-field form of engine/step.py, cases/thermal.py) held against
lbm_tpu on the CPU: the runtime-force step, the uniform-temperature
degenerate case, the conduction profile, the heated cavity against
lbm_tpu's BuoyantTransport on both routes, checkpoints, the Nusselt
profile, the bridge and the CLI."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.cases import thermal as ref_cases
from lbm_tpu.engine import step as ref_step
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.thermal import BuoyantTransport as RefBuoyant
from lbm_tpu_torch import bridge
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.cases import thermal as cases
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.step import (
    boussinesq_force,
    initial_f,
    make_step,
    make_step_force,
)
from lbm_tpu_torch.engine.thermal import BuoyantTransport
from lbm_tpu_torch.kernels import collide_stream as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

THERMAL_CASES = {
    "rayleigh_benard": dict(nx=16, ny=1, nz=10),
    "heated_cavity": dict(n=12),
    "heated_cavity_3d": dict(n=10),
    "rayleigh_benard_3d": dict(nx=12, ny=10, nz=8, seed=3),
}


@pytest.mark.parametrize("name", sorted(THERMAL_CASES))
def test_thermal_cases_equal_lbm_tpu(name):
    """The port's own copy of cases/thermal.py builds the same spec,
    arguments and bookkeeping."""
    rspec, rkw, rinfo = getattr(ref_cases, name)(**THERMAL_CASES[name])
    spec, kw, info = getattr(cases, name)(**THERMAL_CASES[name])
    assert info == rinfo and spec.name == rspec.name == name
    assert spec.shape == rspec.shape and spec.tau == rspec.tau
    assert np.array_equal(spec.mask, rspec.mask) and not spec.boundaries
    assert sorted(kw) == sorted(rkw)
    for key in kw:
        np.testing.assert_array_equal(np.asarray(kw[key]),
                                      np.asarray(rkw[key]))


@pytest.mark.parametrize("collision", ["bgk", "trt", "mrt"])
def test_make_step_force_matches_lbm_tpu(collision):
    """The dense step with a seeded per-cell force field against lbm_tpu's
    make_step_force, 6 steps on the lid cavity (an NEE plane keeps the
    static force): f at rtol 3e-6 / atol 1e-7; u, a difference of
    populations of order 0.05 summed in another order, at atol 5e-7."""
    kw = dict(n=12, collision=collision)
    cc, rcc = (compile_case(get_case("lid_driven_cavity", **kw)),
               ref_compile_case(ref_get_case("lid_driven_cavity", **kw)))
    rng = np.random.default_rng(5)
    force = (1e-4 * rng.standard_normal((3, 12, 12, 12))).astype(np.float32)
    f, rf = initial_f(cc), ref_step.initial_f(rcc)
    step = make_step_force(cc)
    rstep = jax.jit(ref_step.make_step_force(rcc))
    for t in range(6):
        f, _, u = step(f, t, torch.from_numpy(force))
        rf, _, ru = rstep(rf, jnp.int32(t), jnp.asarray(force))
    np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=3e-6,
                               atol=1e-7)
    np.testing.assert_allclose(u.numpy(), np.asarray(ru), rtol=3e-6,
                               atol=5e-7)


@pytest.mark.parametrize("collision", ["bgk", "trt"])
def test_uniform_temperature_is_the_constant_force_path(collision):
    """A uniform temperature under buoyancy exerts the constant force
    buoyancy (c - c_ref) at every fluid cell: the field form of the step
    and the kernel's plain version equal the constant-force step bit for
    bit."""
    kw = dict(n=10, nz=10, collision=collision)
    spec = get_case("gravity_channel", fz=3e-5, **kw)
    free = dataclasses.replace(spec, force=None)
    cc, cf = compile_case(spec), compile_case(free)
    g = torch.zeros((7,) + cc.shape)
    g[0] = 1.25                         # c = 1.25 everywhere
    field = K.ForceField((0.0, 0.0, 4e-5), 0.5)   # 4e-5 * 0.75 = 3e-5
    assert np.float32(4e-5) * np.float32(0.75) == np.float32(3e-5)
    F = boussinesq_force(g, cf.fluid, field.buoyancy, field.c_ref)
    fa, fb, fc = initial_f(cc), initial_f(cf), initial_f(cf)
    for t in range(8):
        fa, _, _ = make_step(cc)(fa, t)
        fb, _, _ = make_step_force(cf)(fb, t, F)
        fc, _ = K.step_plain(fc, cf, t, field, g)
    assert torch.equal(fa, fb) and torch.equal(fa, fc)
    assert K.instance(cf, field) == f"{collision}+field"


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_conduction_profile_is_exact(backend):
    """Zero buoyancy: conduction between the hot and cold plates settles
    on the linear profile with half-way walls, to 1e-6 (the Dirichlet
    link's own anchor, independent of lbm_tpu)."""
    spec, kw, info = cases.heated_cavity_3d(n=10, ra=1e3)
    bt = BuoyantTransport(spec, device="cpu", backend=backend,
                          **dict(kw, buoyancy=(0.0, 0.0, 0.0)))
    bt.run(500)
    c = bt.concentration().numpy()
    x = np.arange(10, dtype=np.float64)
    lin = 0.5 - (x - 0.5) / info["H"]
    fluid = bt.fluid.numpy()
    err = np.abs(c - lin[:, None, None])[fluid].max()
    assert err < 1e-6, err
    planes, nu = bt.nusselt_profile(0, info["kappa"], info["dT"], info["H"])
    np.testing.assert_allclose(nu, 1.0, atol=1e-5)
    assert list(planes) == list(range(2, 8))


@pytest.mark.parametrize("backend,case", [
    ("dense", "heated_cavity"), ("kernel", "heated_cavity"),
    ("dense", "rayleigh_benard"), ("kernel", "rayleigh_benard")])
def test_buoyant_transport_matches_lbm_tpu(backend, case):
    """The laterally periodic quasi-2D cases, 40 steps, against lbm_tpu's
    dense BuoyantTransport: the dense route at c atol 2e-6 and u rtol
    2e-5 of its scale; the kernel route's plain versions at lbm_tpu's own
    tolerance between its routes (c rtol 1e-4 / atol 1e-5, u 3e-4 of its
    scale)."""
    args = dict(n=14) if case == "heated_cavity" else dict(nx=16, nz=10)
    rspec, rkw, info = getattr(ref_cases, case)(**args)
    spec, kw, _ = getattr(cases, case)(**args)
    ref = RefBuoyant(rspec, **rkw)
    port = BuoyantTransport(spec, device="cpu", backend=backend, **kw)
    ref.run(40)
    assert port.run(40) is None and port.t == 40
    c_tol = dict(atol=2e-6) if backend == "dense" else dict(rtol=1e-4,
                                                            atol=1e-5)
    np.testing.assert_allclose(port.concentration().numpy(),
                               np.asarray(ref.concentration()), **c_tol)
    (rho, u), (rrho, ru) = port.macro(), ref.macro()
    scale = np.abs(np.asarray(ru)).max()
    assert scale > 1e-5
    np.testing.assert_allclose(
        u.numpy(), np.asarray(ru),
        atol=(2e-5 if backend == "dense" else 3e-4) * scale)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rrho), rtol=3e-6)
    hot = 0 if case == "heated_cavity" else 2
    p, nu = port.nusselt_profile(hot, info["kappa"], info["dT"], info["H"])
    rp, rnu = ref.nusselt_profile(hot, info["kappa"], info["dT"], info["H"])
    assert np.array_equal(p, rp)
    np.testing.assert_allclose(nu, rnu, rtol=1e-4, atol=1e-5)


def test_record_energy_matches_lbm_tpu():
    """run(record_energy=True) on the dense route: the per-step kinetic
    energy of the in-step velocity; the kernel route names the dense one."""
    rspec, rkw, _ = ref_cases.rayleigh_benard(nx=16, nz=10)
    spec, kw, _ = cases.rayleigh_benard(nx=16, nz=10)
    e_ref = RefBuoyant(rspec, **rkw).run(30, record_energy=True)
    e = BuoyantTransport(spec, device="cpu", backend="dense", **kw).run(
        30, record_energy=True)
    assert e.shape == (30,) and e[-1] > 0
    np.testing.assert_allclose(e, e_ref, rtol=1e-4)
    with pytest.raises(ValueError, match="backend='dense'"):
        BuoyantTransport(spec, device="cpu", **kw).run(2, record_energy=True)


def test_save_restore_resumes_bit_identically(tmp_path):
    """save/restore: the resumed trajectory equals the uninterrupted one
    bit for bit on both routes; a checkpoint of another case or shape is
    refused; lbm_tpu reads the file too."""
    spec, kw, _ = cases.heated_cavity(n=12)
    path = str(tmp_path / "thermal.ckpt.npz")
    for backend in ("kernel", "dense"):
        a = BuoyantTransport(spec, device="cpu", backend=backend, **kw)
        a.run(10)
        a.save(path)
        assert not os.path.exists(path + ".tmp.npz")
        a.run(10)
        b = BuoyantTransport(spec, device="cpu", backend=backend, **kw)
        b.restore(path)
        assert b.t == 10
        b.run(10)
        assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
    rspec, rkw, _ = ref_cases.heated_cavity(n=12)
    ref = RefBuoyant(rspec, **rkw)
    ref.restore(path)
    assert ref.t == 10
    other, okw, _ = cases.heated_cavity(n=14)
    with pytest.raises(ValueError, match="do not match"):
        BuoyantTransport(other, device="cpu", **okw).restore(path)
    renamed = dataclasses.replace(spec, name="another_case")
    with pytest.raises(ValueError, match="is for case"):
        BuoyantTransport(renamed, device="cpu", **kw).restore(path)


def test_kernel_route_refusals_name_the_dense_backend():
    """The force-field kernel composes with BGK and TRT only and carries
    no CaseSpec.force; the dense route runs all of them."""
    spec, kw, _ = cases.heated_cavity_3d(n=8)
    for opts in (dict(collision="mrt"), dict(smagorinsky_cs=0.1),
                 dict(force=(0.0, 0.0, 1e-6))):
        refused = dataclasses.replace(spec, **opts)
        with pytest.raises(NotImplementedError, match="backend='dense'"):
            BuoyantTransport(refused, device="cpu", **kw)
        bt = BuoyantTransport(refused, device="cpu", backend="dense", **kw)
        bt.run(3)
        assert bool(torch.isfinite(bt.f).all())
    with pytest.raises(ValueError, match="3-vector"):
        BuoyantTransport(spec, device="cpu", **dict(kw, buoyancy=(0.0, 1.0)))


def test_bridge_carries_a_buoyant_transport():
    """A lbm_tpu BuoyantTransport's state and arguments carried into the
    port after 15 steps and stepped 15 more in each package."""
    rspec, rkw, _ = ref_cases.heated_cavity(n=12)
    ref = RefBuoyant(rspec, **rkw)
    ref.run(15)
    kw = bridge.transport_kwargs_from_reference(ref, wall_c=rkw["wall_c"])
    assert kw["buoyancy"] == tuple(float(np.float32(v))
                                   for v in rkw["buoyancy"])
    port = BuoyantTransport(bridge.case_from_reference(rspec), device="cpu",
                            backend="dense", **kw)
    state = bridge.transport_state_from_reference(ref)
    assert state["f"].shape == (19,) + rspec.shape
    bridge.load_transport_state(port, state)
    ref.run(15)
    port.run(15)
    assert port.t == 30
    np.testing.assert_allclose(port.g.numpy(), np.asarray(ref.g), atol=2e-6)
    np.testing.assert_allclose(port.f.numpy(), np.asarray(ref.f), rtol=3e-6,
                               atol=1e-7)


@pytest.mark.parametrize("case,n,extra", [
    ("cavity", 12, []), ("rb", 8, []), ("cavity3d", 10, ["--vtk"]),
    ("rb3d", 12, ["--nz", "8", "--backend", "dense"])])
def test_cli_thermal_runs_every_case_on_the_cpu(tmp_path, case, n, extra):
    proc = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch", "thermal", "--device", "cpu",
         "--thermal-case", case, "--n", str(n), "--steps", "6", "--chunks",
         "2", "--out", str(tmp_path)] + extra,
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "chunk 1: t=12  Nu=" in proc.stdout and "ms/step" in proc.stdout
    if "--vtk" in extra:
        assert os.listdir(tmp_path) == ["heated_cavity_3d_12.vtk"]
        with open(tmp_path / "heated_cavity_3d_12.vtk", "rb") as fh:
            head = fh.read(4096)
        assert b"SCALARS TEMPERATURE float" in head
