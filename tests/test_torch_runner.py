"""lbm_tpu_torch's Simulation, checkpoints, bridge and CLI held against
lbm_tpu on the CPU, plus the port's refusals and its independence from
JAX."""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine import checkpoint as ref_ckpt
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu_torch import bridge
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.core.bouzidi import link_q
from lbm_tpu_torch.engine import checkpoint as ckpt
from lbm_tpu_torch.engine.compile import CURVED_REFUSAL, compile_case
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.step import initial_f, make_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_runner_matches_reference_velsum_series():
    """200 steps of lid16: per-step velsum samples, step count and stop
    decision as lbm_tpu's dense runner (whose samples come from its
    jitted 200-step chunk)."""
    ref = RefSimulation(ref_get_case("lid_driven_cavity", n=16),
                        backend="xla")
    r_ref = ref.run(max_steps=200, time_save=200, verbose=False)
    ref.reset()
    _, _, s_ref = ref._build_chunk(200)(ref.f, jnp.int32(0))

    sim = Simulation(get_case("lid_driven_cavity", n=16), device="cpu")
    res = sim.run(max_steps=200, time_save=50, verbose=False)
    np.testing.assert_allclose(res.velsum_series, np.asarray(s_ref),
                               rtol=1e-5)
    assert (res.steps, res.converged) == (r_ref.steps, r_ref.converged)
    assert len(res.residual_history) == 4 and sim.t == 200


def test_runner_stops_where_reference_stops():
    """A cavity small enough to converge: the stag_max rule (whose count
    is never reset) stops both runners at the same chunk."""
    kw = dict(n=10)
    r_ref = RefSimulation(ref_get_case("lid_driven_cavity", **kw),
                          backend="xla").run(max_steps=1000, time_save=100,
                                             verbose=False)
    res = Simulation(get_case("lid_driven_cavity", **kw), device="cpu").run(
        max_steps=1000, time_save=100, verbose=False)
    assert res.converged and r_ref.converged
    assert res.steps == r_ref.steps < 1000
    np.testing.assert_allclose(res.residual_history, r_ref.residual_history,
                               rtol=0.05, atol=1e-7)


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_usq_flavor_matches_reference(backend):
    spec = dataclasses.replace(get_case("poiseuille", n=12),
                               residual_flavor="usq")
    ref_spec = dataclasses.replace(ref_get_case("poiseuille", n=12),
                                   residual_flavor="usq")
    r_ref = RefSimulation(ref_spec, backend="xla").run(
        max_steps=60, time_save=20, verbose=False)
    sim = Simulation(spec, device="cpu", backend=backend)
    res = sim.run(max_steps=60, time_save=20, verbose=False)
    assert res.steps == r_ref.steps == 60 and res.velsum_series is None
    np.testing.assert_allclose(res.residual_history[1:],
                               r_ref.residual_history[1:], rtol=1e-3)
    assert res.residual_history[0] == float("inf")


def test_backends_agree_and_mlups_conventions():
    spec = get_case("poiseuille", n=12)
    a = Simulation(spec, device="cpu", backend="kernel")
    b = Simulation(spec, device="cpu", backend="dense")
    ra = a.run(max_steps=30, time_save=7, verbose=False)
    rb = b.run(max_steps=30, time_save=30, verbose=False)
    assert torch.equal(a.f, b.f)
    np.testing.assert_array_equal(ra.velsum_series, rb.velsum_series)
    mask = spec.mask
    assert ra.mlups_box / ra.mlups == pytest.approx(mask.size
                                                    / (mask != 0).sum())
    assert ra.mlups_live / ra.mlups == pytest.approx((mask == 4).sum()
                                                     / (mask != 0).sum())
    for (rho_a, u_a), (rho_b, u_b) in [(a.macro(), b.macro())]:
        assert torch.equal(rho_a, rho_b) and torch.equal(u_a, u_b)
    rho, u = a.macro()
    nonfluid = ~a.cc.fluid
    assert torch.equal(rho[nonfluid], a.cc.rho0[nonfluid])
    assert torch.equal(u[:, nonfluid], a.cc.u0[:, nonfluid])


def test_case_from_reference_gives_the_same_run():
    ref_spec = ref_get_case("poiseuille", n=16)
    spec = bridge.case_from_reference(ref_spec)
    own = get_case("poiseuille", n=16)
    cc_a, cc_b = compile_case(spec), compile_case(own)
    fa, fb = initial_f(cc_a), initial_f(cc_b)
    sa, sb = make_step(cc_a), make_step(cc_b)
    for t in range(4):
        fa, _, _ = sa(fa, t)
        fb, _, _ = sb(fb, t)
    assert torch.equal(fa, fb)
    assert spec.boundaries[0].u_field is not ref_spec.boundaries[0].u_field
    assert type(spec.units).__module__.startswith("lbm_tpu_torch")


def test_state_bridge_round_trip():
    f = np.random.default_rng(0).random((19, 3, 4, 5)).astype(np.float32)
    t = bridge.state_from_numpy(f)
    assert t.dtype == torch.float32 and t.is_contiguous()
    t.add_(1.0)  # the state is a copy, not a view of the caller's array
    np.testing.assert_array_equal(bridge.state_to_numpy(t), f + 1.0)
    with pytest.raises(ValueError):
        bridge.state_from_numpy(f[0])


def test_reference_checkpoint_resumes_in_port(tmp_path):
    path = str(tmp_path / "ref.ckpt.npz")
    ref = RefSimulation(ref_get_case("lid_driven_cavity", n=16),
                        backend="xla")
    ref.run(max_steps=5, time_save=5, verbose=False)
    ref_ckpt.save_sim(path, ref)
    saved_velsum = ref._last_velsum
    ref.run(max_steps=5, time_save=5, verbose=False)

    sim = Simulation(get_case("lid_driven_cavity", n=16), device="cpu")
    ckpt.restore(sim, path)
    assert sim.t == 5 and sim._last_velsum == saved_velsum is not None
    sim.run(max_steps=5, time_save=5, verbose=False)
    assert sim.t == ref.t == 10
    np.testing.assert_allclose(sim.f.numpy(), np.asarray(ref.f_standard()),
                               rtol=3e-6, atol=1e-7)


def test_port_checkpoint_resumes_in_reference(tmp_path):
    path = str(tmp_path / "port.ckpt.npz")
    sim = Simulation(get_case("poiseuille", n=16), device="cpu")
    sim.run(max_steps=5, time_save=5, verbose=False)
    ckpt.save_sim(path, sim)
    sim.run(max_steps=5, time_save=5, verbose=False)

    ref = RefSimulation(ref_get_case("poiseuille", n=16), backend="xla")
    ref_ckpt.restore(ref, path)
    assert ref.t == 5
    ref.run(max_steps=5, time_save=5, verbose=False)
    np.testing.assert_allclose(np.asarray(ref.f_standard()), sim.f.numpy(),
                               rtol=3e-6, atol=1e-7)
    # and back: the port's own round trip is exact
    other = Simulation(get_case("poiseuille", n=16), device="cpu")
    ckpt.restore(other, path)
    other.run(max_steps=5, time_save=5, verbose=False)
    assert torch.equal(other.f, sim.f)


def test_checkpoint_rejects_wrong_case(tmp_path):
    path = str(tmp_path / "c.npz")
    sim = Simulation(get_case("lid_driven_cavity", n=8), device="cpu")
    ckpt.save_sim(path, sim)
    other = Simulation(get_case("poiseuille", n=8), device="cpu")
    with pytest.raises(ValueError, match="case"):
        ckpt.restore(other, path)


def test_cli_writes_vtk_and_convergence_log(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch", "run", "--device", "cpu",
         "--case", "lid_driven_cavity", "--opt", "n=16", "--steps", "50",
         "--time-save", "25", "--checkpoint-every", "2", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    files = sorted(os.listdir(out))
    assert files == ["CONVERGENCE.log", "lid_driven_cavity.ckpt.npz",
                     "lid_driven_cavity_25.vtk", "lid_driven_cavity_50.vtk"]
    log = (out / "CONVERGENCE.log").read_text().splitlines()
    assert len(log) == 3 and log[-1].startswith("TOTAL RUNNING TIME")
    vtk = (out / "lid_driven_cavity_50.vtk").read_text().splitlines()
    assert vtk[4] == "DIMENSIONS 12 12 12" and vtk[8] == "VECTORS VELOCITY float"
    listing = subprocess.run([sys.executable, "-m", "lbm_tpu_torch", "list"],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
    assert listing.stdout.split() == ["bifurcation", "coronary",
                                      "curved_vessel", "gravity_channel",
                                      "lid_driven_cavity", "pipe",
                                      "poiseuille"]


_FORCE = dict(force=(1e-6, 0.0, 0.0))
_PLAW = {"model": "power_law", "K": 0.05, "n": 0.7}


@pytest.mark.parametrize("name,kwargs,match", [
    ("lid_driven_cavity", dict(collision="mrt", **_FORCE), "backend='dense'"),
    ("lid_driven_cavity", dict(smagorinsky_cs=0.1, **_FORCE),
     "backend='dense'"),
    ("lid_driven_cavity", dict(rheology=_PLAW, **_FORCE), "backend='dense'"),
    ("gravity_channel", dict(n=8, nz=8, collision="trt", rheology=_PLAW),
     "backend='dense'"),
    # Bouzidi walls: the kernel backend refuses them in lbm_tpu's words
    # (the ids kept from when the refusal named the ROADMAP item)
    pytest.param("pipe", dict(n=16, nz=4, curved=True), CURVED_REFUSAL,
                 id="pipe-kwargs4-ROADMAP.md Queue 1 item 8"),
    pytest.param("coronary", dict(shape=(24, 20, 32), radius=4,
                                  windkessel=[(1.0, 1.0, 1.0)] * 4,
                                  curved=True), CURVED_REFUSAL,
                 id="coronary-kwargs5-ROADMAP.md Queue 1 item 8"),
])
def test_refuses_unported_features(name, kwargs, match):
    """What the kernel backend does not run raises by name: the two
    compositions the collide-stream kernel lacks (pointing at 'dense')
    and Bouzidi curved walls (in lbm_tpu's words, pointing at 'dense' and
    'sparse'), with windkessel outlets too; compile_case takes the curved
    specs (the dense and sparse backends run them)."""
    if name == "lid_driven_cavity":
        kwargs = dict(kwargs, n=8)
    spec = get_case(name, **kwargs)
    with pytest.raises(NotImplementedError, match=re.escape(match)):
        Simulation(spec, device="cpu")
    if spec.wall_sdf is not None:
        assert compile_case(spec).bouzidi is not None
        assert (link_q(np.asarray(spec.mask), spec.wall_sdf) != 0.5).any()


def test_refuses_unported_boundaries():
    # windkessel outlets compile (ported); the outlet keeps its triple
    spec = get_case("poiseuille", n=8, windkessel=(1.0, 1.0, 1.0))
    assert compile_case(spec).bcs[1].windkessel == (1.0, 1.0, 1.0)
    # a wall_sdf compiles (Bouzidi links; a flat sdf folds every q to
    # 1/2: plain bounce-back, a = 1, b_up = b_loc = 0) and the kernel
    # backend refuses it by name
    spec = get_case("poiseuille", n=8)
    spec.wall_sdf = np.ones(spec.shape, np.float32)
    assert bool((link_q(np.asarray(spec.mask), spec.wall_sdf) == 0.5).all())
    _, _, a, b_up, b_loc = compile_case(spec).bouzidi
    assert bool((a == 1).all() and (b_up == 0).all() and (b_loc == 0).all())
    with pytest.raises(NotImplementedError, match="Bouzidi"):
        Simulation(spec, device="cpu")
    # five x/y-plane boundaries: one more than the kernel's descriptor
    # array; z-plane boundaries do not count (coronary has three)
    spec = get_case("poiseuille", n=8)
    spec.boundaries = spec.boundaries * 2 + spec.boundaries[:1]
    with pytest.raises(NotImplementedError, match="at most 4"):
        compile_case(spec)
    assert len(compile_case(get_case(
        "coronary", shape=(24, 20, 32), radius=4)).z_bcs) == 3


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Simulation(get_case("lid_driven_cavity", n=8), device="cuda")
    with pytest.raises(ValueError, match="backend"):
        Simulation(get_case("lid_driven_cavity", n=8), device="cpu",
                   backend="pallas")


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lbm_tpu_torch\n"
        "for m in pkgutil.walk_packages(lbm_tpu_torch.__path__, "
        "'lbm_tpu_torch.'):\n"
        "    if m.name != 'lbm_tpu_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'lbm_tpu', "
        "'tools') or k.startswith(('jax.', 'jaxlib', 'lbm_tpu.', 'tools.')))\n"
        "assert not bad, bad\n"
        "from lbm_tpu_torch.geometry import native\n"
        "from lbm_tpu_torch.kernels import _build\n"
        "assert native._LIB is None, 'an import built the geometry library'\n"
        "assert _build._load_all.cache_info().currsize == 0, 'an import "
        "built the kernels'\n"
        "print(len([k for k in sys.modules if k.startswith('lbm_tpu_torch')]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 20
