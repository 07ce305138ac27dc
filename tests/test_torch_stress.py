"""The port's stress and wall-shear outputs (engine/stress.py,
Simulation.stress/wss/wss_accumulator, run --wss/--wss-stats) against
lbm_tpu's engine/stress.py on the CPU: wall normals exactly; sigma, WSS,
TAWSS from the same state, with the windkessel P_c threaded, at rtol
1e-4 and an absolute floor of 1e-5 of the field's largest value or 1e-8,
whichever is larger (the two sum the 19 populations in different orders,
and f - feq cancels to the fp32 rounding of populations of order 1/3); OSI, a ratio of nearly
cancelling means, at atol 1e-3 where TAWSS exceeds 1e-3 of its largest
value (below that it is rounding noise in both)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine import stress as ref_stress
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine import stress
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.io.vtk import case_vtk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WK = (5e-4, 24000.0, 2.5e-3)
WK4 = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3), (1e-4, 5e3, 4e-3),
       (1e-4, 5e3, 8e-3)]
COR_WK = dict(shape=(48, 24, 40), radius=5, windkessel=WK4, pulsatile=(4, 8))
BLOOD = {"model": "carreau", "nu0": 0.05, "nu_inf": 0.005, "lam": 10.0,
         "n": 0.5}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the boxes here are small, and a thread pool
    spends its time waiting for its threads when the suite runs files in
    parallel workers, which made this file many times slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=max(1e-5 * np.abs(b).max(), 1e-8))


@pytest.mark.parametrize("name,kw", [
    ("coronary", dict(shape=(48, 24, 40), radius=5)),
    ("coronary", dict(shape=(48, 24, 40), radius=5, curved=True)),
    ("poiseuille", dict(n=16)),
])
def test_wall_normals_equal_lbm_tpus(name, kw):
    spec = get_case(name, **kw)
    ref = ref_get_case(name, **kw)
    np.testing.assert_array_equal(
        stress.wall_normals(spec.mask, spec.wall_sdf),
        ref_stress.wall_normals(ref.mask, ref.wall_sdf))


def _pair(name, kw, steps, backend="kernel"):
    """lbm_tpu's dense run of `steps` steps and a port Simulation holding
    its state, step count and P_c."""
    ref = RefSimulation(ref_get_case(name, **kw), backend="xla")
    ref.run(max_steps=steps, time_save=steps, verbose=False)
    sim = Simulation(get_case(name, **kw), device="cpu", backend=backend)
    sim.set_f_standard(np.array(ref.f_standard()))
    sim.t = ref.t
    if ref.wk is not None:
        sim.wk = torch.from_numpy(np.array(ref.wk))
    return ref, sim


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_wk_stress_and_wss_thread_state(backend):
    """Simulation.stress(), wss() and wss_accumulator() on the windkessel
    pulsatile coronary, with P_c threaded, against lbm_tpu's; the
    accumulator over two samples a few steps apart (TAWSS and OSI)."""
    ref, sim = _pair("coronary", COR_WK, 20, backend)
    for a, b in zip(sim.stress(), ref.stress()):
        _close(a, b)
    w, rw = sim.wss(), ref.wss()
    assert float(w.max()) > 0
    _close(w, rw)
    acc, racc = sim.wss_accumulator(), ref.wss_accumulator()
    for _ in range(2):
        acc.sample_sim(sim)
        racc.sample_sim(ref)
        ref.run(max_steps=3, time_save=3, verbose=False)
        sim.set_f_standard(np.array(ref.f_standard()))
        sim.t, sim.wk = ref.t, torch.from_numpy(np.array(ref.wk))
    assert acc.n_samples == 2
    tawss = np.asarray(racc.tawss_field())
    _close(acc.tawss_field(), tawss)
    sel = tawss > 1e-3 * tawss.max()
    np.testing.assert_allclose(acc.osi_field().numpy()[sel],
                               np.asarray(racc.osi_field())[sel], atol=1e-3)
    assert float(acc.osi_field().max()) > 0


@pytest.mark.parametrize("name,kw", [
    ("poiseuille", dict(n=16, windkessel=WK, collision="trt",
                        rheology=BLOOD)),
    ("gravity_channel", dict(n=16, nz=16, collision="trt")),
    ("lid_driven_cavity", dict(n=16, smagorinsky_cs=0.1)),
])
def test_stress_fields_of_each_branch(name, kw):
    """sigma with a closure's per-cell tau (and a windkessel outlet), with
    the Guo force's correction, and with LES, against lbm_tpu's
    stress_fields of the same state; wss_field and the traction."""
    ref, sim = _pair(name, kw, 12, "dense")
    rcc = ref.cc
    f = jnp.asarray(np.array(ref.f))
    wk = ref.wk
    for a, b in zip(stress.stress_fields(sim.cc, sim.f, sim.t, wk=sim.wk),
                    ref_stress.stress_fields(rcc, f, ref.t, wk=wk)):
        _close(a, b)
    n = stress.wall_normals(sim.spec.mask)
    _close(stress.wss_field(sim.cc, sim.f, sim.t, n, wk=sim.wk),
           ref_stress.wss_field(rcc, f, ref.t, n, wk=wk))
    _close(stress.tangential_traction(sim.cc, sim.f, sim.t, n, wk=sim.wk),
           ref_stress.tangential_traction(rcc, f, ref.t, n, wk=wk))


def test_vtk_writes_the_wss_field(tmp_path):
    _, sim = _pair("coronary", COR_WK, 8)
    path = case_vtk(sim, str(tmp_path), sim.t, include_density=True,
                    binary=True, include_wss=True,
                    extra_fields={"OSI": np.zeros(sim.spec.shape)})
    raw = open(path, "rb").read()
    assert b"SCALARS WSS float" in raw and b"SCALARS OSI float" in raw
    n = int(np.prod([s - 2 * c for s, c in
                     zip(sim.spec.shape, sim.spec.vtk_crops)]))
    head = b"SCALARS WSS float\nLOOKUP_TABLE default\n"
    start = raw.index(head) + len(head)
    got = np.frombuffer(raw[start:start + 4 * n], ">f4")
    cx, cy, cz = sim.spec.vtk_crops
    want = (sim.wss().numpy() * sim.spec.units.C_pre)[
        cx:-cx, cy:-cy, cz:-cz].transpose(2, 1, 0).ravel()
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_cli_run_prints_pc_and_writes_wall_fields(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch", "run", "--device", "cpu",
         "--case", "coronary", "--opt", "shape=[48,24,40]", "radius=5",
         "windkessel=" + str([list(w) for w in WK4]).replace(" ", ""),
         "pulsatile=[4,8]", "--steps", "8", "--time-save", "4", "--wss",
         "--wss-stats", "--vtk-final", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("Windkessel P_c (mmHg gauge): ")]
    assert len(line) == 1 and len(line[0].split(":")[1].split()) == 4
    raw = (out / "coronary_8.vtk").read_bytes()
    for name in (b"WSS", b"TAWSS", b"OSI"):
        assert b"SCALARS " + name + b" float" in raw


def test_compiled_case_carries_what_stress_reads():
    """The port's stress reads the compiled case's fluid, rho0 and u0
    (lbm_tpu's too): the two compiles agree on them."""
    spec = get_case("coronary", **COR_WK)
    cc, rcc = compile_case(spec), ref_compile_case(
        ref_get_case("coronary", **COR_WK))
    np.testing.assert_array_equal(cc.fluid.numpy(), np.asarray(rcc.fluid))
    np.testing.assert_array_equal(cc.u0.numpy(), np.asarray(rcc.u0))
    np.testing.assert_array_equal(cc.rho0.numpy(), np.asarray(rcc.rho0))
