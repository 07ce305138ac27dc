"""The live-cell (sparse) backend of lbm_tpu_torch on the CPU, held
against lbm_tpu's sparse engine: the compacted tables exactly; the step
on lid 16, poiseuille 16, coronary 32x24x40, curved_vessel 32 and the two
curved cases (pipe, curved coronary) at lbm_tpu's sparse/dense bound (f
at fluid cells, rtol 3e-6 / atol 1e-7, tests/test_sparse.py), windkessel
outlets with P_c at rtol 3e-5 / atol 1e-8, velsum at 1e-5 relative;
the port's sparse step equal to its dense step bit for bit; the
live-cell stress (wss_sparse, SparseWSSAccumulator) against lbm_tpu's,
and the kernel backend's live-cell WSS route against its dense route;
checkpoints across backends; the snapshot files byte for byte lbm_tpu's;
the profiler trace; run --backend sparse --snapshots --profile and the
kernel backend's refusal through the CLI; the refusals."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine import sparse as ref_sparse
from lbm_tpu.engine import stress as ref_stress
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.io import snapshots as ref_snapshots
from lbm_tpu_torch import bridge
from lbm_tpu_torch.bridge import case_from_reference
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.core.bouzidi import link_q
from lbm_tpu_torch.engine import checkpoint as ckpt
from lbm_tpu_torch.engine import sparse, stress
from lbm_tpu_torch.engine.compile import compile_case, wk_init
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.step import initial_f, make_step, make_step_wk
from lbm_tpu_torch.geometry.mask import compact_index
from lbm_tpu_torch.io import snapshots
from lbm_tpu_torch.utils.profiling import Meter, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 3e-6, 1e-7            # lbm_tpu's sparse/dense bound
WK_RTOL, WK_ATOL = 3e-5, 1e-8      # lbm_tpu's windkessel bound
WK4 = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3), (1e-4, 5e3, 4e-3),
       (1e-4, 5e3, 8e-3)]
CURVED_COR = dict(shape=(48, 24, 40), radius=5, curved=True)
CASES = {
    "lid": ("lid_driven_cavity", dict(n=16)),
    "poiseuille": ("poiseuille", dict(n=16)),
    "coronary": ("coronary", dict(shape=(32, 24, 40), radius=5)),
    "curved_vessel": ("curved_vessel", dict(n=32, nphase=4,
                                            period_steps=8)),
    "pipe": ("pipe", dict(n=20, nz=4, radius=5.6)),
    "coronary_curved": ("coronary", CURVED_COR),
}
WK_CASES = {
    "coronary_wk": ("coronary", dict(shape=(32, 24, 40), radius=5,
                                     windkessel=WK4, pulsatile=(4, 8))),
    "coronary_curved_wk": ("coronary", dict(CURVED_COR, windkessel=WK4,
                                            pulsatile=(4, 8))),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: small boxes in parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_wk0(rs):
    p0 = [b.windkessel_p0 for b in rs.boundaries if b.windkessel is not None]
    return jnp.asarray(p0, jnp.float32) if p0 else None


def _ref_sparse_run(sc, steps, wk=None):
    f = ref_sparse.initial_f_sparse(sc)
    if wk is None:
        step = jax.jit(ref_sparse.make_sparse_step(sc))
        for t in range(steps):
            f, _, _ = step(f, jnp.int32(t))
        return np.asarray(f), None
    step = jax.jit(ref_sparse.make_sparse_step_wk(sc))
    for t in range(steps):
        f, _, _, wk = step(f, jnp.int32(t), wk)
    return np.asarray(f), np.asarray(wk)


def _port_sparse_run(sc, steps):
    f = sparse.initial_f_sparse(sc)
    w0 = wk_init(sc.bcs)
    if w0 is None:
        step = sparse.make_sparse_step(sc)
        for t in range(steps):
            f, _, _ = step(f, t)
        return f, None
    wk = torch.from_numpy(w0)
    step = sparse.make_sparse_step_wk(sc)
    for t in range(steps):
        f, _, _, wk = step(f, t, wk)
    return f, wk


def test_compact_index_is_lbm_tpus():
    from lbm_tpu.geometry.mask import compact_index as ref_compact_index

    mask = np.asarray(get_case("coronary", shape=(32, 24, 40),
                               radius=5).mask)
    idx, n = compact_index(mask)
    ridx, rn = ref_compact_index(mask)
    assert n == rn and np.array_equal(idx, ridx)


@pytest.mark.parametrize("label", sorted(CASES))
def test_sparse_step_matches_lbm_tpu_sparse(label):
    """6 steps: the compacted tables exactly (ids, walls, fluid, the
    compacted link_q bit for bit), f at fluid cells at the bound, and the
    port's own dense step equal bit for bit (the same arithmetic per
    cell)."""
    name, kw = CASES[label]
    rs = ref_get_case(name, **kw)
    spec = case_from_reference(rs)
    rsc = ref_sparse.compile_sparse(rs, lane_multiple=256)
    sc = sparse.compile_sparse(spec)
    n = sc.n_live
    assert n == rsc.n_live and np.array_equal(sc.index, rsc.index)
    assert np.array_equal(sc.nbr_idx[1:].numpy(),
                          np.asarray(rsc.nbr_idx)[1:, :n])
    assert np.array_equal(sc.nbr_wall.numpy(), np.asarray(rsc.nbr_wall)[:, :n])
    assert np.array_equal(sc.fluid.numpy(), np.asarray(rsc.fluid)[:n])
    assert sc.velsum_offset == pytest.approx(rsc.velsum_offset, rel=1e-12)
    if rsc.link_q is not None:   # the port's link_q at the live cells
        q = link_q(np.asarray(spec.mask), spec.wall_sdf)
        assert np.array_equal(q.reshape(19, -1)[:, sc.live_flat.numpy()],
                              np.asarray(rsc.link_q)[:, :n])
    steps = 6
    f_ref, _ = _ref_sparse_run(rsc, steps)
    f, _ = _port_sparse_run(sc, steps)
    fl = sc.fluid.numpy()
    np.testing.assert_allclose(f.numpy()[:, fl], f_ref[:, :n][:, fl],
                               rtol=RTOL, atol=ATOL)
    cc = compile_case(spec)
    d = initial_f(cc)
    step = make_step(cc)
    for t in range(steps):
        d, _, _ = step(d, t)
    assert torch.equal(sparse.scatter_dense(sc, f)[:, cc.fluid],
                       d[:, cc.fluid])


@pytest.mark.parametrize("label", sorted(WK_CASES))
def test_sparse_windkessel_matches_lbm_tpu_sparse(label):
    """40 steps with four RCR outlets (until P_c is above rounding): f at
    the step bound, P_c at the windkessel bound; the port's dense step
    with the same carry equal bit for bit in f (P_c sums its flux in
    another order)."""
    name, kw = WK_CASES[label]
    rs = ref_get_case(name, **kw)
    spec = case_from_reference(rs)
    rsc = ref_sparse.compile_sparse(rs, lane_multiple=256)
    sc = sparse.compile_sparse(spec)
    steps = 40
    f_ref, wk_ref = _ref_sparse_run(rsc, steps, _ref_wk0(rs))
    f, wk = _port_sparse_run(sc, steps)
    fl = sc.fluid.numpy()
    np.testing.assert_allclose(f.numpy()[:, fl], f_ref[:, :sc.n_live][:, fl],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wk.numpy(), wk_ref, rtol=WK_RTOL,
                               atol=WK_ATOL)
    assert np.abs(wk.numpy()).max() > 1e-4
    cc = compile_case(spec)
    d, dwk = initial_f(cc), torch.from_numpy(wk_init(cc.bcs))
    step = make_step_wk(cc)
    for t in range(steps):
        d, _, _, dwk = step(d, t, dwk)
    np.testing.assert_allclose(dwk.numpy(), wk.numpy(), rtol=WK_RTOL,
                               atol=WK_ATOL)
    torch.testing.assert_close(sparse.scatter_dense(sc, f)[:, cc.fluid],
                               d[:, cc.fluid], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("label", ["lid", "coronary", "curved_vessel",
                                   "coronary_curved", "coronary_wk"])
def test_sparse_runner_velsum_and_macro_match_lbm_tpu(label):
    """Simulation(backend='sparse'): a chunk's velsum samples (the fluid
    cells' |u| plus velsum_offset) against lbm_tpu's sparse chunk at 1e-5
    relative (3e-5, the windkessel bound, with RCR outlets), the carried
    P_c, macro() and f_standard() against lbm_tpu's."""
    name, kw = {**CASES, **WK_CASES}[label]
    rs = ref_get_case(name, **kw)
    ref = RefSimulation(rs, backend="sparse")
    args = (ref.f, jnp.int32(0)) + (() if ref.wk is None else (ref.wk,))
    out = ref._build_chunk(24)(*args)
    ref.f, ref.t = out[0], 24
    if ref.wk is not None:
        ref.wk = out[3]
    sim = Simulation(case_from_reference(rs), device="cpu", backend="sparse")
    samples = np.concatenate([sim._advance(8) for _ in range(3)])
    rtol = 1e-5 if ref.wk is None else WK_RTOL
    np.testing.assert_allclose(samples, np.asarray(out[2]), rtol=rtol)
    if ref.wk is not None:
        np.testing.assert_allclose(sim.wk.numpy(), np.asarray(ref.wk),
                                   rtol=WK_RTOL, atol=WK_ATOL)
    fl = np.asarray(rs.mask) == 4
    live = np.asarray(rs.mask) != 0
    f, f_ref = sim.f_standard().numpy(), np.asarray(ref.f_standard())
    np.testing.assert_allclose(f[:, fl], f_ref[:, fl], rtol=RTOL, atol=ATOL)
    assert (f[:, ~live] == 0).all()
    rho, u = sim.macro()
    rho_ref, u_ref = ref.macro()
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=3e-5,
                               atol=5e-7)


def test_bridge_carries_lbm_tpus_sparse_state():
    """Both packages step on from one compacted state (lbm_tpu's, 30 steps
    in): the pad dropped on the way in, restored on the way out."""
    rs = ref_get_case("coronary", **CURVED_COR)
    rsc = ref_sparse.compile_sparse(rs, lane_multiple=256)
    f_ref, _ = _ref_sparse_run(rsc, 30)
    sc = sparse.compile_sparse(case_from_reference(rs))
    f = bridge.sparse_state_from_reference(rsc, f_ref)
    assert f.shape == (19, sc.n_live)
    assert np.array_equal(bridge.sparse_state_to_reference(rsc, f),
                          np.where(np.arange(rsc.n_pad) < sc.n_live, f_ref,
                                   0.0))
    ref_step = jax.jit(ref_sparse.make_sparse_step(rsc))
    step = sparse.make_sparse_step(sc)
    g = jnp.asarray(f_ref)
    for t in range(30, 34):
        g, _, _ = ref_step(g, jnp.int32(t))
        f, _, _ = step(f, t)
    fl = sc.fluid.numpy()
    np.testing.assert_allclose(f.numpy()[:, fl],
                               np.asarray(g)[:, :sc.n_live][:, fl],
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="sparse state"):
        bridge.sparse_state_from_reference(rsc, f_ref[:, :10])


@pytest.mark.parametrize("label", ["coronary_curved_wk", "coronary"])
def test_sparse_wss_matches_lbm_tpu(label):
    """wss_sparse and SparseWSSAccumulator (two samples) against
    lbm_tpu's, and Simulation.wss() on the sparse backend (which always
    takes the live-cell route) against lbm_tpu's sparse Simulation, from
    one state 40 steps in."""
    name, kw = {**CASES, **WK_CASES}[label]
    rs = ref_get_case(name, **kw)
    ref = RefSimulation(rs, backend="sparse")
    args = (ref.f, jnp.int32(0)) + (() if ref.wk is None else (ref.wk,))
    out = ref._build_chunk(40)(*args)
    ref.f, ref.t = out[0], 40
    if ref.wk is not None:
        ref.wk = out[3]
    sim = Simulation(case_from_reference(rs), device="cpu", backend="sparse")
    sim.set_f_standard(np.array(ref.f_standard()))
    sim.t = 40
    if ref.wk is not None:
        sim.wk = torch.from_numpy(np.array(ref.wk))
    assert sim._wss_via_sparse()
    w, w_ref = sim.wss().numpy(), np.asarray(ref.wss())
    assert (w != 0).sum() == (w_ref != 0).sum() > 50
    np.testing.assert_allclose(w, w_ref, rtol=1e-4, atol=1e-9)
    sc, f_s = sim._sparse_cc_f()
    rsc, rf_s = ref._sparse_cc_f()
    nrm = stress.compact_normals(sc, stress.wall_normals(rs.mask,
                                                         rs.wall_sdf))
    assert np.array_equal(nrm.numpy(), ref_stress.compact_normals(
        rsc, ref_stress.wall_normals(rs.mask, rs.wall_sdf))[:, :sc.n_live])
    ws = stress.wss_sparse(sc, f_s, sim.t, nrm, wk=sim.wk)
    ws_ref = ref_stress.wss_sparse(rsc, rf_s, ref.t, wk=ref.wk)
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_ref)[:sc.n_live],
                               rtol=1e-4, atol=1e-9)
    acc, acc_ref = sim.wss_accumulator(), ref.wss_accumulator()
    assert isinstance(acc, stress.SparseWSSAccumulator)
    for _ in range(2):   # each sample of one state, lbm_tpu's
        acc.sample_sim(sim)
        acc_ref.sample_sim(ref)
        ref.run(max_steps=4, time_save=4, verbose=False)
        sim.set_f_standard(np.array(ref.f_standard()))
        sim.t = ref.t
        if ref.wk is not None:
            sim.wk = torch.from_numpy(np.array(ref.wk))
    np.testing.assert_allclose(acc.tawss().numpy(),
                               np.asarray(acc_ref.tawss())[:sc.n_live],
                               rtol=1e-4, atol=1e-9)
    tawss = np.asarray(acc_ref.tawss_field())
    sel = tawss > 1e-3 * tawss.max()   # where the traction is not noise
    np.testing.assert_allclose(acc.osi_field().numpy()[sel],
                               np.asarray(acc_ref.osi_field())[sel],
                               atol=1e-3)
    assert acc.tawss_field().shape == tuple(rs.shape)


def test_kernel_live_cell_wss_route_matches_the_dense_route(monkeypatch):
    """On the kernel backend (its plain versions here) the live-cell route
    gathers the live cells straight out of the (19, X, Y, Z) state; at
    every wall-adjacent fluid cell it is the dense route's WSS, the same
    per-cell arithmetic on the same values: equal bit for bit. The route
    is lbm_tpu's size rule, forced here on a small box."""
    spec = get_case("coronary", shape=(32, 24, 40), radius=5,
                    windkessel=WK4, pulsatile=(4, 8))
    sim = Simulation(spec, device="cpu")
    sim.run(max_steps=30, time_save=15, verbose=False)
    assert not sim._wss_via_sparse()
    dense = sim.wss()
    acc_d = sim.wss_accumulator()
    monkeypatch.setattr(Simulation, "_wss_via_sparse", lambda self: True)
    live = sim.wss()
    assert torch.equal(live, dense) and (live != 0).sum() > 50
    sc, f_s = sim._sparse_cc_f()
    assert torch.equal(f_s, sparse.gather_live(sc, sim.f))
    acc = sim.wss_accumulator()
    assert isinstance(acc, stress.SparseWSSAccumulator)
    acc.sample_sim(sim)
    acc_d.sample_sim(sim)
    assert torch.equal(acc.tawss_field(), acc_d.tawss_field())
    # the size rule: 5 * 19 * 4 * cells > 6e9, the full coronary and up
    monkeypatch.undo()
    big = Simulation.__new__(Simulation)
    big.backend, big.spec = "kernel", get_case("lid_driven_cavity", n=8)
    big.spec.shape = (291, 291, 372)
    assert big._wss_via_sparse()
    big.spec.shape = (224, 224, 224)
    assert not big._wss_via_sparse()


def test_checkpoint_round_trip_kernel_sparse_dense(tmp_path):
    """A checkpoint written on the kernel backend (its plain versions)
    restores on the sparse one, whose checkpoint restores on the dense one:
    20 steps through the three equal a 20-step kernel run, f at fluid
    cells at the step bound, P_c at the windkessel bound."""
    spec = get_case("coronary", **CURVED_COR, windkessel=WK4,
                    pulsatile=(4, 8))
    straight = get_case("coronary", shape=(48, 24, 40), radius=5,
                        windkessel=WK4, pulsatile=(4, 8))
    # the kernel backend refuses curved walls: the straight tree there
    for sp, first in ((straight, "kernel"), (spec, "dense")):
        whole = Simulation(sp, device="cpu", backend=first)
        whole.run(max_steps=20, time_save=10, verbose=False)
        a = Simulation(sp, device="cpu", backend=first)
        a.run(max_steps=8, time_save=8, verbose=False)
        p1 = str(tmp_path / f"{first}1.npz")
        ckpt.save_sim(p1, a)
        b = Simulation(sp, device="cpu", backend="sparse")
        ckpt.restore(b, p1)
        assert b.t == 8 and torch.equal(b.wk, a.wk)
        b.run(max_steps=6, time_save=6, verbose=False)
        p2 = str(tmp_path / f"{first}2.npz")
        ckpt.save_sim(p2, b)
        c = Simulation(sp, device="cpu", backend="dense")
        ckpt.restore(c, p2)
        assert c.t == 14 and c._last_usq == b._last_usq
        c.run(max_steps=6, time_save=6, verbose=False)
        fl = c.cc.fluid
        torch.testing.assert_close(c.f_standard()[:, fl],
                                   whole.f_standard()[:, fl], rtol=RTOL,
                                   atol=ATOL)
        torch.testing.assert_close(c.wk, whole.wk, rtol=WK_RTOL,
                                   atol=WK_ATOL)


def test_snapshot_files_are_lbm_tpus_byte_for_byte(tmp_path):
    rng = np.random.default_rng(11)
    spec = get_case("coronary", shape=(32, 24, 40), radius=5)
    u = rng.normal(0.0, 0.05, (3,) + tuple(spec.shape)).astype(np.float32)
    u[:, 3, 4, 5] = [1e-9, -2.5, 123456.0]
    for name, mine, theirs, extra in (
            ("meas1.txt", snapshots.write_midplane,
             ref_snapshots.write_midplane, ()),
            ("s1_out.txt", snapshots.write_midplane_fluid,
             ref_snapshots.write_midplane_fluid, (spec.mask,)),
            ("vel.csv", snapshots.write_bc_csv, ref_snapshots.write_bc_csv,
             (spec.mask,))):
        a, b = tmp_path / ("port_" + name), tmp_path / ("ref_" + name)
        mine(str(a), torch.from_numpy(u), *extra)
        theirs(str(b), u, *extra)
        assert a.read_bytes() == b.read_bytes() and a.stat().st_size > 1000


def test_meter_and_trace(tmp_path):
    m = Meter(1000)
    with m:
        m.add_steps(5)
    assert m.steps == 5 and m.mlups > 0 and "5 steps" in m.report()
    sim = Simulation(get_case("pipe", n=20, nz=4, radius=5.6), device="cpu",
                     backend="sparse")
    with trace(str(tmp_path / "prof")):
        sim.run(max_steps=2, time_save=2, verbose=False)
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert '"traceEvents"' in text and "aten::gather" in text


def test_cli_sparse_snapshots_profile_and_the_kernel_refusal(tmp_path):
    """run --backend sparse --snapshots --profile on the small curved
    coronary (files written, trace not empty), run --case pipe on dense
    and on sparse, and on the default kernel backend a non-zero exit in
    lbm_tpu's words."""
    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "lbm_tpu_torch", "run", "--device", "cpu",
             *args], cwd=ROOT, capture_output=True, text=True, timeout=240)

    out, prof = tmp_path / "cor", tmp_path / "prof"
    proc = run("--case", "coronary", "--backend", "sparse", "--snapshots",
               "--profile", str(prof), "--wss", "--steps", "8",
               "--time-save", "4", "--out", str(out), "--opt",
               "shape=[48,24,40]", "radius=5", "curved=true",
               "pulsatile=[4,8]")
    assert proc.returncode == 0, proc.stderr
    assert "TOTAL RUNNING TIME" in proc.stdout
    for name in ("meas1.txt", "s1_out.txt", "vel.csv", "coronary_8.vtk"):
        assert (out / name).stat().st_size > 0
    assert (prof / "trace.json").stat().st_size > 1000
    for backend in ("dense", "sparse"):
        proc = run("--case", "pipe", "--backend", backend, "--steps", "4",
                   "--time-save", "2", "--no-vtk", "--out",
                   str(tmp_path / backend), "--opt", "n=20", "nz=4",
                   "radius=5.6")
        assert proc.returncode == 0, proc.stderr
        assert "TOTAL RUNNING TIME" in proc.stdout
    proc = run("--case", "pipe", "--steps", "2", "--out",
               str(tmp_path / "k"), "--opt", "n=20", "nz=4")
    assert proc.returncode != 0
    assert ("backend='kernel' does not support wall_sdf (Bouzidi curved "
            "walls) — use backend='dense' or 'sparse'") in proc.stderr


def test_sparse_refusals():
    """The sparse backend refuses what lbm_tpu's does, in its words."""
    spec = get_case("lid_driven_cavity", n=8)
    for kw, match in ((dict(store_dtype="bf16"), "dense/sparse backends"),
                      (dict(fuse=2), "backend='sparse' has none"),
                      (dict(lowmem=True), "live cells only"),
                      (dict(mesh=object()), "single-device")):
        with pytest.raises(ValueError, match=match):
            Simulation(spec, device="cpu", backend="sparse", **kw)
    with pytest.raises(ValueError, match="'kernel', 'dense' or 'sparse'"):
        Simulation(spec, device="cpu", backend="xla")
