"""The collision branches of lbm_tpu_torch on the CPU (TRT, the Guo body
force, moving walls, the LES / rheology closures, MRT): the dense step
held against lbm_tpu's per branch, the kernel route's refusals, K3's
force shift, the MRT and closure parameters, the new cases, the bridge,
the CLI, and the kernels' collision descriptor against the CUDA
source."""

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
from lbm_tpu.core import mrt as ref_mrt
from lbm_tpu.core import rheology as ref_rheology
from lbm_tpu.engine import step as ref_step
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu_torch import bridge
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.core import mrt, rheology
from lbm_tpu_torch.engine.compile import compile_case, kernel_refusal
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.step import (
    initial_f,
    macro_fields,
    make_step,
    moving_bb_terms,
    tau_eff_field,
)
from lbm_tpu_torch.kernels import _build
from lbm_tpu_torch.kernels import collide_stream as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARREAU = {"model": "carreau", "nu0": 0.1, "nu_inf": 0.01, "lam": 100.0,
           "n": 0.4}
CHANNEL = dict(n=16, nz=16, fz=1e-4)

# branch -> (case, options). 16^3 boxes; the channel's force is 10x its
# default so that the source terms move f well above the tolerance.
BRANCHES = {
    "bgk+force": ("gravity_channel", CHANNEL),
    "trt": ("lid_driven_cavity", dict(n=16, collision="trt")),
    "trt+force": ("gravity_channel", dict(CHANNEL, collision="trt")),
    "mrt": ("lid_driven_cavity", dict(n=16, collision="mrt")),
    "mrt+force": ("gravity_channel", dict(CHANNEL, collision="mrt")),
    "moving": ("lid_driven_cavity", dict(n=16, lid="bounceback")),
    "smag": ("lid_driven_cavity", dict(n=16, smagorinsky_cs=0.15)),
    "plaw": ("lid_driven_cavity", dict(n=16, rheology={
        "model": "power_law", "K": 0.02, "n": 0.7})),
    "cy": ("lid_driven_cavity", dict(n=16, rheology=CARREAU)),
    "cy_a1.5": ("lid_driven_cavity", dict(n=16, rheology=dict(
        CARREAU, model="carreau_yasuda", a=1.5))),
    "casson": ("lid_driven_cavity", dict(n=16, rheology={
        "model": "casson", "nu_c": 0.02, "tau_y": 1e-5})),
    "trt+cy": ("poiseuille", dict(n=16, collision="trt", rheology=CARREAU)),
    "smag+force": ("gravity_channel", dict(CHANNEL, smagorinsky_cs=0.15)),
    "trt+cy+force": ("gravity_channel", dict(CHANNEL, collision="trt",
                                             rheology=CARREAU)),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_dense_step_matches_lbm_tpu(branch):
    """20 steps of the port's dense step against lbm_tpu.engine.step
    (XLA on the CPU) at rtol 3e-6 / atol 1e-7, the tolerance lbm_tpu's
    own backend tests use per branch (tests/test_trt.py:106,
    test_mrt.py:124, test_les.py:88, test_rheology.py:219,
    test_moving_wall.py:103); the step's u (with the F/2 shift) at atol
    1e-6, since it sums ten populations, each within 1e-7."""
    name, kw = BRANCHES[branch]
    cc = compile_case(get_case(name, **kw))
    ref = ref_compile_case(ref_get_case(name, **kw))
    f, rf = initial_f(cc), ref_step.initial_f(ref)
    st, rst = make_step(cc), jax.jit(ref_step.make_step(ref))
    for t in range(20):
        f, _, u = st(f, t)
        rf, _, ru = rst(rf, jnp.int32(t))
    assert float((f - initial_f(cc)).abs().max()) > 1e-5  # the flow moved
    np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=3e-6,
                               atol=1e-7)
    fluid = np.asarray(ref.fluid)
    np.testing.assert_allclose(u.numpy()[:, fluid], np.asarray(ru)[:, fluid],
                               rtol=3e-6, atol=1e-6)


def test_moving_lid_drives_the_cavity_like_the_nee_lid():
    """The bounce-back lid (Ladd term) spins the cavity up the same way
    as the reference's NEE lid: same sign and order of the flow."""
    runs = {}
    for lid in ("nee", "bounceback"):
        sim = Simulation(get_case("lid_driven_cavity", n=12, lid=lid),
                         device="cpu")
        sim.run(max_steps=60, time_save=60, verbose=False)
        runs[lid] = sim.macro()[1][2][6, 8]           # u_z under the lid
    nee, moving = runs["nee"], runs["bounceback"]
    assert float(moving.max()) > 0 and float(nee.max()) > 0
    assert 0.5 < float(moving.max() / nee.max()) < 2.0


@pytest.mark.parametrize("kw", [dict(collision="mrt"),
                                dict(smagorinsky_cs=0.15),
                                dict(rheology=CARREAU),
                                dict(collision="trt", rheology=CARREAU)])
def test_kernel_route_refuses_what_its_kernel_lacks(kw):
    """MRT + force and closure + force: NotImplementedError naming
    backend='dense' on the kernel route (the Simulation and the wrappers
    alike), never a silent switch; the dense backend runs them."""
    spec = get_case("gravity_channel", n=10, nz=8, **kw)
    assert kernel_refusal(spec) is not None
    with pytest.raises(NotImplementedError, match="backend='dense'"):
        Simulation(spec, device="cpu")
    cc = compile_case(spec)
    f = initial_f(cc)
    with pytest.raises(NotImplementedError, match="backend='dense'"):
        K.step(f, f.clone(), cc, torch.zeros(1, dtype=torch.float64), 0, 0)
    sim = Simulation(spec, device="cpu", backend="dense")
    res = sim.run(max_steps=5, time_save=5, verbose=False)
    assert res.steps == 5 and bool(torch.isfinite(sim.f).all())
    assert kernel_refusal(get_case("gravity_channel", n=10, nz=8)) is None


def test_macro_with_force_matches_lbm_tpu():
    """K3's force shift (its plain version on the CPU): u = (m + F/2) /
    rho, against lbm_tpu's macro_fields; Simulation.macro applies it."""
    name, kw = BRANCHES["trt+force"]
    spec = get_case(name, **kw)
    sim = Simulation(spec, device="cpu")
    sim.run(max_steps=10, time_save=10, verbose=False)
    ref = ref_compile_case(ref_get_case(name, **kw))
    rho_r, u_r = ref_step.macro_fields(ref, jnp.asarray(sim.f.numpy()))
    rho, u = K.macro(sim.f, spec.force)
    fluid = np.asarray(ref.fluid)
    np.testing.assert_allclose(rho.numpy()[fluid], np.asarray(rho_r)[fluid],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(u.numpy()[:, fluid], np.asarray(u_r)[:, fluid],
                               rtol=1e-6, atol=1e-7)
    rho_s, u_s = sim.macro()
    assert torch.equal(u_s, macro_fields(sim.cc, sim.f)[1])
    assert torch.equal(u_s[:, sim.cc.fluid], u[:, sim.cc.fluid])
    shift = u - K.macro(sim.f)[1]
    assert float(shift[2][sim.cc.fluid].min()) > 0  # F/2 along +z


@pytest.mark.parametrize("rates", [None, {"e": 1.0, "q": 1.5},
                                   {"m": 1.0 / 0.7}])
def test_mrt_matrices_equal_lbm_tpu(rates):
    m, d = mrt.mrt_basis()
    m_r, d_r = ref_mrt.mrt_basis()
    np.testing.assert_array_equal(m, m_r)
    np.testing.assert_array_equal(d, d_r)
    for tau in (0.55, 0.7, 1.3):
        for a, b in zip(mrt.mrt_matrices(tau, rates),
                        ref_mrt.mrt_matrices(tau, rates)):
            np.testing.assert_array_equal(a, b)
        assert mrt.mrt_rank_update(tau, rates) == \
            ref_mrt.mrt_rank_update(tau, rates)


def test_mrt_rank_update_is_the_dense_matrix():
    """lbm_tpu's kernel form, f - s_nu fneq + sum_r coef_r (m_r . fneq)
    m_r, is f - K fneq on seeded fneq whose conserved moments vanish (no
    force), in float64; its rows are the parity-definite tunable rows."""
    rng = np.random.default_rng(3)
    for rates in (None, {"e": 1.0 / 0.62}):
        k, _ = mrt.mrt_matrices(0.62, rates)
        m, d = mrt.mrt_basis()
        fneq = rng.standard_normal(19)
        cons = [0, 3, 5, 7]
        fneq -= m[cons].T @ ((m[cons] @ fneq) / d[cons])
        rows, coefs = mrt.mrt_rank_update(0.62, rates)
        assert len(rows) == (10 if rates is None else 9)
        rank = -fneq / 0.62 + sum(c * (np.asarray(r) @ fneq) * np.asarray(r)
                                  for r, c in zip(rows, coefs))
        np.testing.assert_allclose(-k @ fneq, rank, rtol=1e-12, atol=1e-12)
    opp = mrt.D3Q19.OPP
    parity = [bool(np.allclose(m[r], m[r][opp])) or
              bool(np.allclose(m[r], -m[r][opp])) for r in mrt.TUNABLE_ROWS]
    assert all(parity)


CLOSURES = {
    "smag": (0.15, None),
    "plaw": (None, {"model": "power_law", "K": 0.02, "n": 0.7}),
    "cy": (None, CARREAU),
    "cy_a1.5": (None, dict(CARREAU, model="carreau_yasuda", a=1.5)),
    "casson": (None, {"model": "casson", "nu_c": 0.02, "tau_y": 1e-4}),
    "casson_newtonian": (None, {"model": "casson", "nu_c": 0.02,
                                "tau_y": 0.0}),
    "bounds": (None, dict(CARREAU, tau_bounds=(0.52, 2.0), iters=3)),
}


@pytest.mark.parametrize("which", sorted(CLOSURES))
def test_tau_eff_from_p_matches_lbm_tpu(which):
    cs, rheo = CLOSURES[which]
    closure = rheology.normalize_closure(cs, rheo)
    assert closure == ref_rheology.normalize_closure(cs, rheo)
    rng = np.random.default_rng(11)
    p = (10.0 ** rng.uniform(-9, -1, 4096)).astype(np.float32)
    inv_rho = (1.0 / rng.uniform(0.9, 1.1, 4096)).astype(np.float32)
    got = rheology.tau_eff_from_p(torch.from_numpy(p),
                                  torch.from_numpy(inv_rho), 0.6, closure)
    want = ref_rheology.tau_eff_from_p(jnp.asarray(p), jnp.asarray(inv_rho),
                                       0.6, closure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-6)
    if which.startswith("cy"):
        assert float(got.max() - got.min()) > 0.1  # the closure is active


def test_closure_parameters_and_errors():
    units = get_case("coronary", shape=(24, 20, 32), radius=4).units
    ref_units = ref_get_case("coronary", shape=(24, 20, 32), radius=4).units
    assert rheology.carreau_blood(units) == \
        ref_rheology.carreau_blood(ref_units)
    g = np.logspace(-4, 2, 7)
    for _, rheo in CLOSURES.values():
        if rheo is None or rheo.get("tau_y") == 0.0:
            continue
        c = rheology.normalize_closure(None, rheo)
        np.testing.assert_array_equal(rheology.nu_of_gamma(g, c),
                                      ref_rheology.nu_of_gamma(g, c))
    for bad in ({"model": "carreau", "nu0": 0.1}, {"model": "bingham"},
                dict(CARREAU, tau_bounds=(0.4, 2.0)),
                dict(CARREAU, extra=1)):
        with pytest.raises(ValueError):
            rheology.normalize_closure(None, bad)
    with pytest.raises(ValueError, match="exclusive"):
        rheology.normalize_closure(0.1, CARREAU)
    with pytest.raises(ValueError, match="MRT"):
        get_case("lid_driven_cavity", n=8, collision="mrt", rheology=CARREAU)
    with pytest.raises(ValueError, match="tau > 1/2"):
        get_case("lid_driven_cavity", n=8, collision="trt", tau=0.5)


def test_blood_closure_stays_inside_its_clip():
    """TRT + Carreau blood on a pulsatile coronary, dense: tau_eff over
    the fluid cells lies inside the closure's clip and varies (the
    non-Newtonian correction is active)."""
    spec = get_case("coronary", shape=(24, 20, 32), radius=4)
    spec = get_case("coronary", shape=(24, 20, 32), radius=4,
                    pulsatile=(4, 8), collision="trt",
                    rheology=rheology.carreau_blood(spec.units))
    sim = Simulation(spec, device="cpu")
    sim.run(max_steps=8, time_save=8, verbose=False)
    te = tau_eff_field(sim.cc, sim.f, sim.t)[sim.cc.fluid]
    assert float(te.min()) >= np.float32(0.5005)
    assert float(te.max()) <= 20.0
    assert float(te.max() - te.min()) > 1e-3


@pytest.mark.parametrize("name,kw", [
    ("gravity_channel", {}),
    ("gravity_channel", dict(n=12, nz=20, fz=3e-5, collision="trt")),
    ("pipe", dict(curved=False)),
    ("pipe", dict(n=24, nz=4)),
])
def test_new_case_specs_match_reference(name, kw):
    spec, ref = get_case(name, **kw), ref_get_case(name, **kw)
    for fld in ("shape", "tau", "force", "collision", "magic_lambda",
                "residual_flavor", "vtk_crops", "stag_max", "tol"):
        assert getattr(spec, fld) == getattr(ref, fld), fld
    for fld in ("mask", "u0", "rho0"):
        np.testing.assert_array_equal(getattr(spec, fld), getattr(ref, fld))
    if ref.wall_sdf is None:
        assert spec.wall_sdf is None
    else:
        np.testing.assert_array_equal(spec.wall_sdf, ref.wall_sdf)
    assert spec.boundaries == [] == ref.boundaries


def test_moving_bb_terms_match_lbm_tpu():
    uw = (0.01, -0.02, 0.06)
    np.testing.assert_array_equal(moving_bb_terms(uw),
                                  ref_step.moving_bb_terms(uw))


def test_case_from_reference_carries_the_collision_fields():
    """The bridge copies collision, magic_lambda, mrt_rates, rheology,
    smagorinsky_cs, force and wall_velocity; both packages then compute
    the same steps."""
    ref_spec = ref_get_case("lid_driven_cavity", n=12, lid="bounceback",
                            collision="trt", magic_lambda=0.25,
                            rheology=CARREAU, force=(0.0, 1e-5, 0.0))
    spec = bridge.case_from_reference(ref_spec)
    for fld in ("collision", "magic_lambda", "mrt_rates", "rheology",
                "smagorinsky_cs", "force", "wall_velocity"):
        assert getattr(spec, fld) == getattr(ref_spec, fld), fld
    assert spec.rheology is not ref_spec.rheology
    mrt_spec = bridge.case_from_reference(ref_get_case(
        "lid_driven_cavity", n=12, collision="mrt", mrt_rates={"e": 1.1},
        smagorinsky_cs=None))
    assert mrt_spec.mrt_rates == {"e": 1.1}
    for s, r in ((spec, ref_spec),
                 (mrt_spec, ref_get_case("lid_driven_cavity", n=12,
                                         collision="mrt",
                                         mrt_rates={"e": 1.1}))):
        cc, ref = compile_case(s), ref_compile_case(r)
        f, rf = initial_f(cc), ref_step.initial_f(ref)
        st, rst = make_step(cc), jax.jit(ref_step.make_step(ref))
        for t in range(6):
            f, _, _ = st(f, t)
            rf, _, _ = rst(rf, jnp.int32(t))
        np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=3e-6,
                                   atol=1e-7)


def test_kernel_instances_and_collision_rows():
    """The instance each case runs and the descriptor rows the kernels
    read: offsets equal to the CUDA source's enums, constants the dense
    step's."""
    src = _build.HEADER.read_text()
    for prefix, table in (("CI", K.CINT), ("CF", K.CFLOAT)):
        enum = {m.group(1): int(m.group(2))
                for m in re.finditer(prefix + r"_(\w+) = (\d+)", src)}
        assert enum == table
    names = {b: K.instance(compile_case(get_case(BRANCHES[b][0],
                                                 **BRANCHES[b][1])))
             for b in ("bgk+force", "trt", "mrt", "moving", "cy", "trt+cy")}
    assert names == {"bgk+force": "bgk+force", "trt": "trt", "mrt": "mrt",
                     "moving": "bgk+moving", "cy": "bgk+cy",
                     "trt+cy": "trt+cy"}
    cc = compile_case(get_case("gravity_channel", **BRANCHES["trt+force"][1]))
    ci, cf = K.collision_tables(cc)
    assert ci.dtype == np.int32 and cf.dtype == np.float32
    assert (ci[K.CINT["coll"]], ci[K.CINT["force"]]) == (1, 1)
    assert cf[K.CFLOAT["two_tau_m"]] == np.float32(2.0 * cc.tau_minus)
    assert cf[K.CFLOAT["half_force"] + 2] == np.float32(0.5e-4)
    cc = compile_case(get_case("lid_driven_cavity", **BRANCHES["cy"][1]))
    ci, cf = K.collision_tables(cc)
    assert (ci[K.CINT["closure"]], ci[K.CINT["iters"]],
            ci[K.CINT["square"]]) == (3, 8, 1)
    assert cf[K.CFLOAT["hi"]] == np.float32(20.0)


def test_cli_runs_force_and_rheology_options(tmp_path):
    """`--opt collision=trt` and a JSON rheology dict reach the case; the
    CLI's --backend dense runs what the kernel route refuses."""
    runs = (
        ["--case", "gravity_channel", "--opt", "collision=trt", "n=12",
         "nz=8"],
        ["--case", "coronary", "--opt", "shape=[24,20,32]", "radius=4",
         "collision=trt", 'rheology={"model": "carreau", "nu0": 0.05, '
         '"nu_inf": 0.005, "lam": 50.0, "n": 0.4}'],
        ["--case", "gravity_channel", "--backend", "dense", "--opt",
         "collision=mrt", "n=12", "nz=8"],
    )
    for k, args in enumerate(runs):
        out = tmp_path / f"run{k}"
        proc = subprocess.run(
            [sys.executable, "-m", "lbm_tpu_torch", "run", "--device", "cpu",
             "--steps", "6", "--time-save", "3", "--out", str(out), *args],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        files = sorted(os.listdir(out))
        assert "CONVERGENCE.log" in files and any(
            f.endswith("_6.vtk") for f in files), files
    proc = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch", "run", "--device", "cpu",
         "--case", "gravity_channel", "--opt", "collision=mrt", "n=12",
         "nz=8", "--steps", "2", "--out", str(tmp_path / "refused")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "backend='dense'" in proc.stderr
