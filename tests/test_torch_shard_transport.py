"""The transports and the windkessel outlets under a mesh, on the CPU:
ranks spawned over gloo (their FileStore in a temporary directory of the
test session, one torch thread each, every spawn bounded by a 60 s
deadline), two spawns for the whole file, each running several cases
(parallel/launch.run_many); the test process itself computes on one
torch thread too, so that the file keeps its pace beside other workers:

  - the sharded kernel route, ScalarTransport(mesh=, backend='kernel'):
    K7's plain version on each rank's halo-row block, on 2 and 4 ranks,
    poiseuille n=16 and the coronary (48, 24, 40) r=5 on y with a bolus
    (lbm_tpu's own cases, tests/test_scalar_pallas.py): g bit for bit
    against the port's unsharded run, the records at rtol 2e-6 / atol
    1e-8, and against lbm_tpu's ScalarTransport at atol 2e-6;
  - the dense ScalarTransport, CoupledTransport and BuoyantTransport on 2
    ranks against the port's unsharded runs (bit for bit where no
    cross-rank sum enters the state), BuoyantTransport also against
    lbm_tpu's mesh= run on the 8-device CPU mesh (tests/test_thermal.py),
    its checkpoint restored without a mesh and its Nusselt profile;
  - the windkessel route, Simulation(mesh=, backend='dense') with an RCR
    outlet, against lbm_tpu's GSPMD run (backend='xla', mesh=) and the
    port's unsharded run at tests/test_windkessel.py's tolerances, and
    CoupledTransport with the small clinical coronary's four outlets;
  - the refusals, in lbm_tpu's words; the shards' cell and footprint
    lists against the whole box's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.cases import thermal as ref_thermal
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.engine.scalar import ScalarTransport as RefScalar
from lbm_tpu.engine.thermal import BuoyantTransport as RefBuoyant
from lbm_tpu.parallel.mesh import lattice_mesh as ref_lattice_mesh
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.scalar import (
    CoupledTransport,
    ScalarTransport,
    bc_geometry,
    blocking_tables,
    compile_scalar_shard,
    scalar_cell_ids,
)
from lbm_tpu_torch.engine.thermal import BuoyantTransport
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.parallel.launch import (
    Gate,
    run_case,
    run_many,
    run_transport,
    spawn,
    transport_setup,
)
from lbm_tpu_torch.parallel.mesh import LatticeMesh

DEADLINE = 60.0
REC_RTOL, REC_ATOL = 2e-6, 1e-8          # tests/test_scalar_pallas.py
WK_RTOL, WK_ATOL = 3e-6, 1e-9            # tests/test_windkessel.py
F_RTOL, F_ATOL = 3e-6, 1e-7
E_RTOL, E_ATOL = 3e-6, 1e-9              # tests/test_thermal.py
WK = (5e-4, 24000.0, 2.5e-3)
WK4 = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3), (1e-4, 5e3, 4e-3),
       (1e-4, 5e3, 8e-3)]
POIS = ("case", "poiseuille", dict(n=16))
COR = ("case", "coronary", dict(shape=(48, 24, 40), radius=5))
PCOR = ("case", "coronary", dict(shape=(48, 24, 40), radius=5,
                                 pulsatile=(4, 8)))
PCOR_WK = ("case", "coronary", dict(shape=(48, 24, 40), radius=5,
                                    pulsatile=(4, 8), windkessel=WK4))
RB = ("thermal", "rayleigh_benard", dict(nx=32, ny=1, nz=18, ra=3000.0,
                                         tau=0.8, perturb=1e-3))
# the frozen cases: (setup, shard axis, keywords, steps, record)
FROZEN = {
    "poiseuille": (POIS, None, dict(D=0.03, inlet_c={0: 1.0}), 48, [0, 1]),
    "coronary": (COR, 1, dict(D=0.03, inlet_c={0: Gate(16)}), 40,
                 [0, 1, 2]),
}
COUPLED = dict(D=0.03, inlet_c={0: Gate(4)}, backend="dense", shard_axis=1)
RB_STEPS = 48
WK_STEPS, WK_SAVE = 21, 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's own torch work on one thread (as its ranks'), the
    worker's setting restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frozen_u(setup):
    """A developing velocity for the frozen cases: 20 dense steps."""
    spec, _ = transport_setup(setup)
    sim = Simulation(spec, device="cpu", backend="dense")
    sim.run(max_steps=20, time_save=20, verbose=False)
    return sim.macro()[1].numpy()


@pytest.fixture(scope="module")
def frozen_u(one_thread):
    return {k: _frozen_u(v[0]) for k, v in FROZEN.items()}


def _frozen_call(name, u, backend):
    setup, axis, kw, steps, rec = FROZEN[name]
    return (run_transport, (setup, "scalar",
                            dict(kw, backend=backend, shard_axis=axis),
                            steps, rec, u[name]))


@pytest.fixture(scope="module")
def sharded(frozen_u, tmp_path_factory):
    """Rank 0's results of every case: {(label, world): result}, from one
    2-rank and one 4-rank spawn (a spawn's start costs more than its
    cases); the checkpoint the 2-rank BuoyantTransport saved."""
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "rb.npz")
    info = transport_setup(RB)[1]
    two = {
        ("kernel poiseuille", 2): _frozen_call("poiseuille", frozen_u,
                                               "kernel"),
        ("kernel coronary", 2): _frozen_call("coronary", frozen_u, "kernel"),
        ("dense coronary", 2): _frozen_call("coronary", frozen_u, "dense"),
        ("coupled", 2): (run_transport, (PCOR, "coupled", COUPLED, 8,
                                         [0, 1, 2])),
        ("coupled wk", 2): (run_transport, (PCOR_WK, "coupled", COUPLED, 8,
                                            [0, 1, 2])),
        ("buoyant", 2): (run_transport, (
            RB, "buoyant", dict(backend="dense", shard_axis=0), RB_STEPS,
            None, None, True, ckpt,
            dict(hot_axis=2, kappa=(info["tau_g"] - 0.5) / 4, dT=1.0,
                 H=16.0))),
        ("wk simulation", 2): (run_case, ("poiseuille", dict(n=16,
                                                             windkessel=WK),
                                          "dense", WK_STEPS, WK_SAVE)),
    }
    four = {
        ("kernel poiseuille", 4): _frozen_call("poiseuille", frozen_u,
                                               "kernel"),
        ("kernel coronary", 4): _frozen_call("coronary", frozen_u, "kernel"),
    }
    out = {}
    for world, calls in ((2, two), (4, four)):
        store = str(tmp_path_factory.mktemp("store"))
        ranks = spawn(run_many, world, (list(calls.values()),),
                      backend="gloo", device="cpu", timeout=DEADLINE,
                      threads=1, store_dir=store)
        for j, key in enumerate(calls):
            out[key] = dict(ranks[0][j], ranks_wk=[r[j].get("wk")
                                                   for r in ranks])
    out["ckpt"] = ckpt
    return out


def _unsharded_frozen(name, u, backend):
    setup, _, kw, steps, rec = FROZEN[name]
    spec, _ = transport_setup(setup)
    tr = ScalarTransport(spec, u[name], device="cpu", backend=backend, **kw)
    return tr, tr.run(steps, record=rec)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(FROZEN))
def test_sharded_kernel_route_equals_the_unsharded_run(sharded, frozen_u,
                                                       name, world):
    """K7's plain version on each rank's halo-row block: the gathered g
    equals the unsharded kernel route's bit for bit, the records (each
    rank's share, added in rank order) at rtol 2e-6 / atol 1e-8; no
    kernel was launched on the CPU."""
    out = sharded[(f"kernel {name}", world)]
    tr, series = _unsharded_frozen(name, frozen_u, "kernel")
    assert np.array_equal(out["g"], tr.g.numpy())
    assert np.array_equal(out["c"], tr.concentration().numpy())
    np.testing.assert_allclose(out["series"], series, rtol=REC_RTOL,
                               atol=REC_ATOL)
    assert out["total"] == pytest.approx(tr.total(), rel=1e-12)
    assert out["launches"] == {}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_sharded_kernel_route_matches_lbm_tpu(sharded, frozen_u, name):
    """The 4-rank run against lbm_tpu's ScalarTransport (dense, one
    device) on the same u: c and the records at atol 2e-6
    (tests/test_torch_scalar.py's tolerance)."""
    setup, _, kw, steps, rec = FROZEN[name]
    _, case, opts = setup
    gate = kw["inlet_c"][0]
    inlet = {0: gate} if name == "poiseuille" else {
        0: lambda t: jnp.where(t < gate.until, 1.0, 0.0)}
    ref = RefScalar(ref_get_case(case, **opts), frozen_u[name], D=kw["D"],
                    inlet_c=inlet)
    series = np.asarray(ref.run(steps, record=rec))
    out = sharded[(f"kernel {name}", 4)]
    np.testing.assert_allclose(out["c"], np.asarray(ref.concentration()),
                               atol=2e-6)
    np.testing.assert_allclose(out["series"], series, atol=2e-6)


def test_dense_scalar_transport_under_a_mesh(sharded, frozen_u):
    """The dense frozen route on 2 ranks of the coronary split on y (its
    z sub-outlet planes cross the face): g bit for bit, the records within
    rtol 2e-6 / atol 1e-8 of the unsharded dense run's."""
    out = sharded[("dense coronary", 2)]
    tr, series = _unsharded_frozen("coronary", frozen_u, "dense")
    assert np.array_equal(out["g"], tr.g.numpy())
    np.testing.assert_allclose(out["series"], series, rtol=REC_RTOL,
                               atol=REC_ATOL)


def _unsharded_coupled(setup, steps, rec):
    spec, _ = transport_setup(setup)
    kw = {k: v for k, v in COUPLED.items() if k != "shard_axis"}
    tr = CoupledTransport(spec, device="cpu", **kw)
    return spec, tr, tr.run(steps, record=rec)


def test_dense_coupled_transport_under_a_mesh(sharded):
    """The pulsatile small coronary through CoupledTransport (div_fix on)
    on 2 ranks: f and g bit for bit off the DEAD cells (the flow's halo
    step, the scalar's spliced pulls and defect's received u planes), the
    records within rtol 2e-6 / atol 1e-8."""
    out = sharded[("coupled", 2)]
    spec, tr, series = _unsharded_coupled(PCOR, 8, [0, 1, 2])
    live = np.asarray(spec.mask) != CellType.DEAD
    assert np.array_equal(out["g"], tr.g.numpy())
    assert np.array_equal(out["f"][:, live], tr.f.numpy()[:, live])
    rho, u = tr.macro()
    assert np.array_equal(out["u"], u.numpy())
    np.testing.assert_allclose(out["series"], series, rtol=REC_RTOL,
                               atol=REC_ATOL)


def test_coupled_transport_with_windkessel_outlets_under_a_mesh(sharded):
    """CoupledTransport with the four RCR outlets on 2 ranks: every rank's
    P_c equal bit for bit, P_c and f within tests/test_windkessel.py's
    tolerances of the unsharded run (the outlets' flux is a cross-rank
    sum), g and the records as close."""
    out = sharded[("coupled wk", 2)]
    spec, tr, series = _unsharded_coupled(PCOR_WK, 8, [0, 1, 2])
    live = np.asarray(spec.mask) != CellType.DEAD
    wk = out["ranks_wk"]
    assert all(np.array_equal(w, wk[0]) for w in wk)
    np.testing.assert_allclose(wk[0], tr.wk.numpy(), rtol=WK_RTOL,
                               atol=WK_ATOL)
    np.testing.assert_allclose(out["f"][:, live], tr.f.numpy()[:, live],
                               rtol=F_RTOL, atol=F_ATOL)
    np.testing.assert_allclose(out["g"], tr.g.numpy(), rtol=F_RTOL,
                               atol=F_ATOL)
    np.testing.assert_allclose(out["series"], series, rtol=REC_RTOL,
                               atol=REC_ATOL)


def _unsharded_buoyant():
    spec, kw = transport_setup(RB)
    bt = BuoyantTransport(spec, device="cpu", backend="dense", **kw)
    return bt, bt.run(RB_STEPS, record_energy=True)


def test_dense_buoyant_transport_under_a_mesh(sharded):
    """Rayleigh-Benard 32x1x18 split on x on 2 ranks: f and g bit for bit
    against the unsharded run, the energy series (the ranks' partials
    added in rank order) within rtol 3e-6 / atol 1e-9, the Nusselt profile
    of the gathered box equal; the checkpoint rank 0 wrote restores into
    an unsharded transport as the unsharded run's state."""
    out = sharded[("buoyant", 2)]
    bt, energy = _unsharded_buoyant()
    assert np.array_equal(out["g"], bt.g.numpy())
    assert np.array_equal(out["f"], bt.f.numpy())
    np.testing.assert_allclose(out["energy"], energy, rtol=E_RTOL,
                               atol=E_ATOL)
    info = transport_setup(RB)[1]
    planes, nu = bt.nusselt_profile(hot_axis=2, kappa=(info["tau_g"] - 0.5)
                                    / 4, dT=1.0, H=16.0)
    assert np.array_equal(out["nusselt"][0], planes)
    np.testing.assert_array_equal(out["nusselt"][1], nu)
    spec, kw = transport_setup(RB)
    back = BuoyantTransport(spec, device="cpu", backend="dense", **kw)
    back.restore(sharded["ckpt"])
    assert back.t == RB_STEPS
    assert torch.equal(back.g, bt.g) and torch.equal(back.f, bt.f)


def test_dense_buoyant_transport_matches_lbm_tpus_mesh_run(sharded):
    """The 2-rank run against lbm_tpu's BuoyantTransport(mesh=) on the
    8-device CPU mesh (tests/test_thermal.py's case) at the tolerances
    tests/test_torch_thermal.py holds the port's dense route to lbm_tpu's
    (energy rtol 1e-4, g atol 2e-6, f rtol 3e-6 / atol 1e-7: the port's
    scalar pass multiplies by the fp32 1/tau_g where lbm_tpu's dense pass
    divides by tau_g)."""
    spec, kw, _ = ref_thermal.rayleigh_benard(**RB[2])
    ref = RefBuoyant(spec, mesh=ref_lattice_mesh(), shard_axis=0, **kw)
    energy = np.asarray(ref.run(RB_STEPS, record_energy=True))
    out = sharded[("buoyant", 2)]
    np.testing.assert_allclose(out["energy"], energy, rtol=1e-4)
    np.testing.assert_allclose(out["g"], np.asarray(ref.g), atol=2e-6)
    np.testing.assert_allclose(out["f"], np.asarray(ref.f), rtol=F_RTOL,
                               atol=F_ATOL)


def test_windkessel_route_matches_lbm_tpu_gspmd_and_unsharded(sharded):
    """Simulation(mesh=, backend='dense') with poiseuille's RCR outlet on
    2 ranks, 21 steps in chunks of 7: P_c and f against lbm_tpu's
    Simulation(backend='xla', mesh=lattice_mesh()) and the port's
    unsharded dense run at rtol 3e-6 / atol 1e-9 (P_c) and 1e-7 (f)."""
    spec = ref_get_case("poiseuille", n=16, windkessel=WK)
    ref = RefSimulation(spec, backend="xla", mesh=ref_lattice_mesh())
    ref.run(max_steps=WK_STEPS, time_save=WK_SAVE, verbose=False)
    port = Simulation(get_case("poiseuille", n=16, windkessel=WK),
                      device="cpu", backend="dense")
    port.run(max_steps=WK_STEPS, time_save=WK_SAVE, verbose=False)
    out = sharded[("wk simulation", 2)]
    live = np.asarray(spec.mask) != CellType.DEAD
    assert out["steps"] == WK_STEPS and (out["f"][:, ~live] == 0).all()
    wk = out["ranks_wk"]
    assert all(np.array_equal(w, wk[0]) for w in wk)
    for f, w in ((np.asarray(ref.f_standard()), np.asarray(ref.wk)),
                 (port.f_standard().numpy(), port.wk.numpy())):
        np.testing.assert_allclose(out["f"][:, live], f[:, live],
                                   rtol=F_RTOL, atol=F_ATOL)
        np.testing.assert_allclose(wk[0], w, rtol=WK_RTOL, atol=WK_ATOL)


def _ring_of_one():
    return LatticeMesh(group=None, rank=0, world=1,
                       device=torch.device("cpu"), backend="gloo")


def _spec(setup):
    return transport_setup(setup)[0]


@pytest.mark.parametrize("which", [
    "scalar kernel on z", "scalar kernel BC on the shard axis",
    "coupled kernel", "buoyant kernel", "simulation kernel windkessel",
    "scalar dense BC on the shard axis"])
def test_refusals_in_lbm_tpus_words(which):
    """What lbm_tpu refuses under a mesh, in its words: the scalar
    kernel's z shard and a boundary on the shard axis, the coupled kernel
    (CoupledTransport, BuoyantTransport), windkessel outlets on the kernel
    backend; the dense route refuses a boundary on the shard axis as the
    flow's halo step does."""
    mesh = _ring_of_one()
    cor = _spec(COR)
    u = np.zeros((3,) + tuple(cor.shape), np.float32)
    if which == "scalar kernel on z":
        with pytest.raises(ValueError, match="keeps z on the lane dim; "
                                             "shard x or y"):
            ScalarTransport(cor, u, D=0.03, device="cpu", mesh=mesh,
                            shard_axis=2)
    elif which == "scalar kernel BC on the shard axis":
        with pytest.raises(ValueError, match="BC on the shard axis"):
            ScalarTransport(cor, u, D=0.03, device="cpu", mesh=mesh,
                            shard_axis=0)
    elif which == "scalar dense BC on the shard axis":
        with pytest.raises(ValueError, match="BC on the shard axis"):
            ScalarTransport(cor, u, D=0.03, device="cpu", mesh=mesh,
                            shard_axis=0, backend="dense")
    elif which == "coupled kernel":
        with pytest.raises(ValueError, match="mesh= is the frozen-field "
                                             "kernel route; the coupled "
                                             "kernel is single-chip"):
            CoupledTransport(_spec(PCOR), D=0.03, device="cpu", mesh=mesh)
    elif which == "buoyant kernel":
        spec, kw = transport_setup(RB)
        with pytest.raises(ValueError, match="the coupled kernel is "
                                             "single-chip"):
            BuoyantTransport(spec, device="cpu", mesh=mesh, **kw)
    else:
        with pytest.raises(ValueError, match=r"GSPMD windkessel is "
                                             r"supported there"):
            Simulation(get_case("poiseuille", n=16, windkessel=WK),
                       device="cpu", mesh=mesh)


@pytest.mark.parametrize("world,halo", [(2, True), (5, True), (3, False)])
def test_shard_lists_partition_the_whole_boxs(world, halo):
    """The coronary (48, 24, 40) split on y (24 rows; 5 ranks pad it to 25
    with a DEAD row): every cell the scalar step touches is listed by
    exactly one rank (its own rows, never a halo or pad row), each
    boundary's footprint likewise, each rank counts the whole footprint,
    and the blocking tables at the listed cells are the whole box's."""
    spec = _spec(COR)
    mask = np.asarray(spec.mask)
    whole = scalar_cell_ids(mask, bc_geometry(spec))
    geo = bc_geometry(spec)
    n = spec.shape[1]
    got, feet = [], [[] for _ in geo]
    nbr_whole = blocking_tables(mask)[0]
    for r in range(world):
        sc = compile_scalar_shard(spec, r, world, 1, "cpu", D=0.03,
                                  halo=halo)
        ids = sc.cells.numpy()
        assert len(ids) and (ids <= np.prod(sc.shape)).all()
        x, y, z = np.unravel_index(ids[ids < np.prod(sc.shape)], sc.shape)
        gy = sc.idx[y]
        assert (gy < n).all()
        if halo:
            assert ((y >= 1) & (y <= sc.rows)).all()
        got.append(np.ravel_multi_index((x, gy, z), spec.shape))
        nbr = sc.nbr_block.numpy()
        assert np.array_equal(nbr[:, x, y, z], nbr_whole[:, x, gy, z])
        for k, bc in enumerate(sc.bcs):
            assert bc.count == max(int(geo[k][4].sum()), 1)
            lat = [a for a in range(3) if a != bc.axis]
            a, b = np.nonzero(bc.valid.numpy())
            ab = [a, b]
            ab[lat.index(1)] = sc.idx[ab[lat.index(1)]]
            feet[k].append(np.ravel_multi_index(ab, geo[k][4].shape))
    got = np.concatenate(got)
    assert len(got) == len(whole) and np.array_equal(np.sort(got), whole)
    for k, parts in enumerate(feet):
        ids = np.concatenate(parts)
        assert len(ids) == len(np.unique(ids))
        assert np.array_equal(np.sort(ids), np.flatnonzero(geo[k][4]))
