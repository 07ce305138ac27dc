"""Simulation(mesh=) of lbm_tpu_torch on the CPU: ranks spawned over gloo
(their FileStore in tmp_path, one torch thread each, every spawn bounded
by a 60 s deadline) run the lid cavity split along x and the coronary
along y, held against lbm_tpu's single-device dense run (fields and
residuals) and, bit for bit, against the port's unsharded run; the
refusals in lbm_tpu's words; checkpoints across world sizes; the dry
run; `run --shard`. The rank function (parallel/launch.run_case) lives
in the port, which imports neither jax nor lbm_tpu."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.parallel.mesh import lattice_mesh as ref_lattice_mesh
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine import checkpoint
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.parallel.dryrun import dryrun_multichip
from lbm_tpu_torch.parallel.launch import run_case, spawn
from lbm_tpu_torch.parallel.mesh import LatticeMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 60.0
RTOL, ATOL = 3e-6, 1e-7
LID = ("lid_driven_cavity", dict(n=16))
CORONARY = ("coronary", dict(shape=(32, 32, 32), radius=5,
                             pulsatile=(4, 8)))
STEPS, SAVE = 8, 4


def _spawn(tmp_path, world, *args, **kw):
    return spawn(run_case, world, args, backend="gloo", device="cpu",
                 timeout=DEADLINE, threads=1, store_dir=str(tmp_path),
                 **kw)[0]


def _unsharded(case, opts, backend="kernel", steps=STEPS):
    sim = Simulation(get_case(case, **opts), device="cpu", backend=backend)
    res = sim.run(max_steps=steps, time_save=SAVE, verbose=False)
    return sim, res


@pytest.fixture(scope="module")
def reference_runs():
    """lbm_tpu's single-device dense runs of the two cases: (f, velsum
    series or None, residual history)."""
    out = {}
    for case, opts in (LID, CORONARY):
        sim = RefSimulation(ref_get_case(case, **opts), backend="xla")
        res = sim.run(max_steps=STEPS, time_save=SAVE, verbose=False)
        series = None
        if case == LID[0]:  # the 'velsum' case: its samples
            ref = RefSimulation(ref_get_case(case, **opts), backend="xla")
            series = np.asarray(ref._build_chunk(STEPS)(ref.f,
                                                        jnp.int32(0))[2])
        out[case] = (np.asarray(sim.f_standard()), series,
                     np.asarray(res.residual_history))
    return out


def _live(case, opts):
    return np.asarray(get_case(case, **opts).mask) != CellType.DEAD


@pytest.mark.parametrize("which,world", [
    ("lid x", 2), ("lid x", 4), ("coronary y", 2), ("coronary y", 4),
    ("coronary dense", 2)])
def test_sharded_simulation_matches_lbm_tpu_and_unsharded(
        tmp_path, reference_runs, which, world):
    """Simulation(mesh=) on `world` gloo ranks, 8 steps in chunks of 4:
    the gathered state (zeros at DEAD cells) and the velsum series or
    residuals against lbm_tpu's dense run (rtol 3e-6, atol 1e-7; series
    at 1e-5), and bit for bit against the port's unsharded run of the
    same backend."""
    case, opts = LID if which.startswith("lid") else CORONARY
    backend = "dense" if which.endswith("dense") else "kernel"
    out = _spawn(tmp_path, world, case, opts, backend, STEPS, SAVE)
    sim, res = _unsharded(case, opts, backend)
    live = _live(case, opts)
    f_ref, vs_ref, hist_ref = reference_runs[case]
    assert out["steps"] == STEPS and (out["f"][:, ~live] == 0).all()
    np.testing.assert_array_equal(out["f"][:, live],
                                  sim.f_standard().numpy()[:, live])
    np.testing.assert_allclose(out["f"][:, live], f_ref[:, live],
                               rtol=RTOL, atol=ATOL)
    if vs_ref is not None:
        np.testing.assert_allclose(out["velsum"], res.velsum_series,
                                   rtol=1e-12)
        np.testing.assert_allclose(out["velsum"], vs_ref, rtol=1e-5)
    np.testing.assert_allclose(out["residuals"], res.residual_history,
                               rtol=1e-9)
    np.testing.assert_allclose(out["residuals"], hist_ref, rtol=1e-4)


def _one_rank_mesh():
    """A ring of one on the CPU: no process group is needed, since a
    world of one exchanges and gathers without communication."""
    return LatticeMesh(group=None, rank=0, world=1,
                       device=torch.device("cpu"), backend="gloo")


class _Gathered(Exception):
    """Stops a gather whose tensors lie on the meta device."""


@pytest.mark.parametrize("backend,wire", [("nccl", "meta"), ("gloo", "cpu")])
def test_host_values_gather_where_the_backend_takes_them(monkeypatch,
                                                         backend, wire):
    """sum_in_rank_order's host float64 values reach all_gather on the
    rank's card under nccl, which takes no host tensor (the meta device
    stands in for the card), and in host memory under gloo, whose sum
    adds the ranks' rows in rank order."""
    seen = []

    def fake_all_gather(parts, src, group=None):
        seen.append({t.device.type for t in parts + [src]})
        if backend == "nccl":
            raise _Gathered
        for r, p in enumerate(parts):
            p.copy_(src + r)

    monkeypatch.setattr(torch.distributed, "all_gather", fake_all_gather)
    mesh = LatticeMesh(None, 0, 3, torch.device("meta"), backend)
    values = np.array([1.0, 2.5])
    if backend == "nccl":
        with pytest.raises(_Gathered):
            mesh.sum_in_rank_order(values)
    else:
        np.testing.assert_array_equal(mesh.sum_in_rank_order(values),
                                      3 * values + 3)
    assert seen == [{wire}]


def test_one_rank_mesh_equals_the_unsharded_run():
    """A world of one takes every sharded code path (compile_shard, the
    halo wrappers, the rank-order sums) and equals the unsharded run bit
    for bit, velsums included; macro() and set_f_standard() round-trip."""
    case, opts = LID
    mesh = Simulation(get_case(case, **opts), device="cpu",
                      mesh=_one_rank_mesh())
    r1 = mesh.run(max_steps=STEPS, time_save=SAVE, verbose=False)
    sim, r2 = _unsharded(case, opts)
    live = torch.from_numpy(_live(case, opts))
    f = mesh.f_standard()
    assert torch.equal(f[:, live], sim.f_standard()[:, live])
    assert not f[:, ~live].any()
    assert torch.equal(mesh.f, sim.f)
    np.testing.assert_array_equal(r1.velsum_series, r2.velsum_series)
    for a, b in zip(mesh.macro(), sim.macro()):
        assert torch.equal(a, b)
    mesh.set_f_standard(sim.f_standard())
    assert torch.equal(mesh.f, sim.f)


def test_refusals_in_lbm_tpu_words():
    """bf16 storage, fuse=2, the kernel backend along z, a boundary on the
    shard axis and lowmem under a mesh are refused; where lbm_tpu refuses
    the same, in its words."""
    mesh = _one_rank_mesh()
    lid = get_case("lid_driven_cavity", n=16)
    ref_lid = ref_get_case("lid_driven_cavity", n=16)
    for kw in (dict(store_dtype="bf16"), dict(fuse=2)):
        with pytest.raises(ValueError) as ours:
            Simulation(lid, device="cpu", mesh=mesh, **kw)
        with pytest.raises(ValueError) as theirs:
            RefSimulation(ref_lid, backend="pallas", mesh=ref_lattice_mesh(),
                          **kw)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="cannot shard along z"):
        Simulation(get_case("curved_vessel", n=24), device="cpu", mesh=mesh)
    Simulation(get_case("curved_vessel", n=24), device="cpu", mesh=mesh,
               backend="dense")
    with pytest.raises(ValueError,
                       match="BC on axis 1 conflicts with shard axis 1"):
        Simulation(lid, device="cpu", mesh=mesh, shard_axis=1)
    with pytest.raises(ValueError, match="lowmem"):
        Simulation(lid, device="cpu", mesh=mesh, lowmem=True)
    with pytest.raises(ValueError, match="mesh"):
        Simulation(lid, device="cpu", shard_axis=0)


def test_checkpoint_restores_across_world_sizes(tmp_path):
    """A checkpoint of 2 ranks restores into an unsharded run and one of
    an unsharded run into 2 ranks; both continue to the uninterrupted
    run's state, bit for bit off the DEAD cells."""
    case, opts = CORONARY
    whole, _ = _unsharded(case, opts, steps=2 * SAVE)
    want = whole.f_standard().numpy()
    live = _live(case, opts)
    two = str(tmp_path / "two.npz")
    _spawn(tmp_path, 2, case, opts, "kernel", SAVE, SAVE, None, two)
    sim = Simulation(get_case(case, **opts), device="cpu")
    checkpoint.restore(sim, two)
    assert sim.t == SAVE
    sim.run(max_steps=SAVE, time_save=SAVE, verbose=False)
    np.testing.assert_array_equal(sim.f_standard().numpy()[:, live],
                                  want[:, live])
    one = str(tmp_path / "one.npz")
    half, _ = _unsharded(case, opts, steps=SAVE)
    checkpoint.save_sim(one, half)
    out = _spawn(tmp_path, 2, case, opts, "kernel", SAVE, SAVE, one)
    assert out["t"] == 2 * SAVE
    np.testing.assert_array_equal(out["f"][:, live], want[:, live])


def test_dryrun_multichip_on_four_ranks():
    assert dryrun_multichip(4, timeout=DEADLINE) == [
        "dense halo step, lid", "kernel route, lid",
        "kernel route, coronary on y",
        "dense halo step with a windkessel outlet, poiseuille",
        "sharded scalar kernel route, lid"]


def test_gloo_ranks_default_to_the_card():
    """A gloo rank's device is the card unless the caller asks for the
    CPU: mesh_device, lattice_mesh and spawn default to 'cuda', which on
    a machine without a card raises in resolve_device's words; 'cpu'
    gives the CPU."""
    import inspect

    from lbm_tpu_torch.parallel.mesh import lattice_mesh, mesh_device

    for fn in (mesh_device, lattice_mesh, spawn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert mesh_device("gloo", 3, "cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert mesh_device("gloo", 0).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            mesh_device("gloo", 0)


def test_a_failing_or_hung_rank_fails_the_run(tmp_path):
    """A rank that raises fails the spawn with its traceback; ranks that
    outlast the deadline are killed and the spawn fails."""
    with pytest.raises(RuntimeError, match="no_such_case"):
        _spawn(tmp_path, 2, "no_such_case", {}, "kernel", 2, 2)
    with pytest.raises(RuntimeError, match="did not finish within"):
        spawn(run_case, 2, ("lid_driven_cavity", dict(n=16), "kernel",
                            10**7, 10**7), backend="gloo", device="cpu",
              timeout=3.0, threads=1, store_dir=str(tmp_path))


def test_cli_run_shard_writes_vtk(tmp_path):
    """`run --device cpu --shard 2` on the coronary: two gloo ranks, rank
    0 writes the VTK files and CONVERGENCE.log."""
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch", "run", "--device", "cpu",
         "--shard", "2", "--case", "coronary", "--steps", "4",
         "--time-save", "2", "--out", str(out), "--opt",
         "shape=[32,32,32]", "radius=5"],
        cwd=ROOT, capture_output=True, text=True, timeout=DEADLINE,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr
    assert "sharded over 2 ranks (gloo) along axis 1" in proc.stdout
    assert sorted(os.listdir(out)) == ["CONVERGENCE.log", "coronary_2.vtk",
                                       "coronary_4.vtk"]
