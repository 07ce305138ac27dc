"""Windkessel (RCR) outlets in lbm_tpu_torch on the CPU, held against
lbm_tpu: the update and the compiled outlet fields exactly; the dense
route against lbm_tpu's 'xla' backend and the kernel route's plain
versions (the collide-stream launch with the outlets' flux folded in, and
the flux kernel that primes it) against lbm_tpu's Pallas step in
interpret mode, both at lbm_tpu's own kernel-against-dense tolerance for
windkessel (f and P_c at rtol 3e-5, atol 1e-8, tests/test_windkessel.py);
the fold's plain sequence bit for bit against a flux from each pre-step
state, its launch list, its primes; checkpoints both ways; the coupled
transport; the flux's fixed summation order; bf16 storage; the
refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine import checkpoint as ref_ckpt
from lbm_tpu.engine import step as ref_step
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.compile import wk_init as ref_wk_init
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.engine.scalar import CoupledTransport as RefCoupled
from lbm_tpu.kernels.collide_stream import (
    make_pallas_step,
    pack_state,
    pad_spec,
    unpack_state,
)
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.core.lattice import D3Q19
from lbm_tpu_torch.engine import checkpoint as ckpt
from lbm_tpu_torch.engine.compile import (
    check_z_windows,
    compile_case,
    fluid_cell_ids,
    wk_footprint,
    wk_init,
)
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.scalar import CoupledTransport
from lbm_tpu_torch.engine.step import (
    initial_f,
    make_step,
    make_step_force,
    make_step_wk,
    pulled_state_wk,
    windkessel_update,
)
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.kernels import collide_stream as K
from lbm_tpu_torch.parallel.mesh import LatticeMesh

RTOL, ATOL = 3e-5, 1e-8  # lbm_tpu's kernel-vs-dense windkessel tolerance
WK = (5e-4, 24000.0, 2.5e-3)  # Rp, C, Rd (lattice); Rd C = 60 steps
WK4 = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3), (1e-4, 5e3, 4e-3),
       (1e-4, 5e3, 8e-3)]
POIS = dict(n=16, windkessel=WK)
COR = dict(shape=(48, 24, 40), radius=5, windkessel=WK4, pulsatile=(4, 8))
PALLAS_STEPS = 24


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
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("wk", [WK, (0.1, 400.0, 2.0), (2e-4, 2e4, 1e-3)])
def test_windkessel_update_equals_lbm_tpus(wk):
    rng = np.random.default_rng(7)
    p = rng.normal(0, 1e-3, 16).astype(np.float32)
    q = rng.normal(0, 1e-2, 16).astype(np.float32)
    for pc, qq in zip(p, q):
        a, b = windkessel_update(torch.tensor(pc), torch.tensor(qq), wk)
        ra, rb = ref_step.windkessel_update(jnp.float32(pc), jnp.float32(qq),
                                            wk)
        assert a.item() == float(ra) and b.item() == float(rb)


@pytest.mark.parametrize("name,kw", [
    ("poiseuille", dict(POIS, windkessel_p0=0.125)),
    ("coronary", COR),
    ("curved_vessel", dict(n=24, nphase=4, period_steps=8, windkessel=WK)),
])
def test_compiled_outlets_equal_lbm_tpus(name, kw):
    cc = compile_case(get_case(name, **kw))
    ref = ref_compile_case(ref_get_case(name, **kw))
    np.testing.assert_array_equal(wk_init(cc.bcs), ref_wk_init(ref.bcs))
    k = 0
    for bc, rbc in zip(cc.bcs, ref.bcs):
        assert bc.windkessel == rbc.windkessel
        assert bc.flow_sign == rbc.flow_sign and bc.wk_p0 == rbc.wk_p0
        if rbc.flow_weight is None:
            assert bc.flow_weight is None and bc.wk_index is None
            continue
        np.testing.assert_array_equal(bc.flow_weight.numpy(),
                                      np.asarray(rbc.flow_weight))
        assert bc.wk_index == k
        k += 1
    assert k == len(wk_init(cc.bcs))


@pytest.mark.parametrize("name,kw,steps", [
    ("poiseuille", POIS, 60),
    ("coronary", COR, 40),
])
def test_dense_route_matches_xla(name, kw, steps):
    """The dense route against lbm_tpu's 'xla' backend: f, the carried
    P_c and every step's velsum."""
    ref = RefSimulation(ref_get_case(name, **kw), backend="xla")
    cc = compile_case(get_case(name, **kw))
    step = make_step_wk(cc)
    rstep = jax.jit(ref_step.make_step_wk(ref.cc))
    f, wk = initial_f(cc), torch.from_numpy(wk_init(cc.bcs))
    rf, rwk = ref.f, ref.wk
    fluid = np.asarray(ref.cc.fluid)
    for t in range(steps):
        f, _, u, wk = step(f, t, wk)
        rf, _, ru, rwk = rstep(rf, jnp.int32(t), rwk)
        vs = float(torch.where(cc.fluid, torch.sqrt((u * u).sum(0)),
                               0.0).sum(dtype=torch.float64))
        rvs = float(np.sqrt((np.asarray(ru) ** 2).sum(0))[fluid].sum(
            dtype=np.float64))
        # lbm_tpu's own velsum tolerance for windkessel routes
        assert vs == pytest.approx(rvs, rel=1e-4)
    _close(f, rf)
    _close(wk, rwk)
    sim = Simulation(get_case(name, **kw), device="cpu", backend="dense")
    sim.run(max_steps=steps, time_save=steps // 2, verbose=False)
    assert torch.equal(sim.f, f) and torch.equal(sim.wk, wk)


@pytest.fixture(scope="module")
def pallas_coronary():
    """lbm_tpu's Pallas step (interpret mode) on the windkessel pulsatile
    coronary: the unpadded f, P_c and the per-step velsums."""
    spec_pad = pad_spec(ref_get_case("coronary", **COR))
    cc_pad = ref_compile_case(spec_pad, light=True)
    step = jax.jit(make_pallas_step(cc_pad, interpret=True))
    p = pack_state(ref_step.initial_f(ref_compile_case(spec_pad)),
                   jnp.asarray(np.asarray(spec_pad.mask)))
    wk = jnp.asarray(ref_wk_init(cc_pad.bcs))
    vs = []
    for t in range(PALLAS_STEPS):
        p, v, wk = step(p, jnp.int32(t), wk)
        vs.append(float(np.asarray(v).sum()))
    f = np.asarray(unpack_state(p))[:, 1:-1, 1:-1, :]
    return np.ascontiguousarray(f), np.asarray(wk), np.asarray(vs)


def _kernel_route(cc, steps):
    f = initial_f(cc)
    out = f.clone()
    wk = torch.from_numpy(wk_init(cc.bcs))
    series = torch.zeros(steps, dtype=torch.float64)
    for t in range(steps):
        K.step(f, out, cc, series, t, t, wk=wk)
        f, out = out, f
    return f, wk, series


def test_kernel_route_matches_pallas_f(pallas_coronary):
    f, _, _ = _kernel_route(compile_case(get_case("coronary", **COR)),
                            PALLAS_STEPS)
    _close(f, pallas_coronary[0])


def test_kernel_route_matches_pallas_wk_and_velsum(pallas_coronary):
    """The fold's route, direct calls and through the runner's chunks
    (each primed once), against lbm_tpu's Pallas route."""
    f, wk, series = _kernel_route(compile_case(get_case("coronary", **COR)),
                                  PALLAS_STEPS)
    _close(wk, pallas_coronary[1])
    np.testing.assert_allclose(series.numpy(), pallas_coronary[2],
                               rtol=1e-4)
    sim = Simulation(dataclasses.replace(get_case("coronary", **COR),
                                         residual_flavor="velsum"),
                     device="cpu")
    res = sim.run(max_steps=PALLAS_STEPS, time_save=PALLAS_STEPS // 3,
                  verbose=False)
    _close(sim.wk, pallas_coronary[1])
    _close(sim.f, pallas_coronary[0])
    np.testing.assert_allclose(res.velsum_series - sim.cc.velsum_offset,
                               pallas_coronary[2], rtol=1e-4)


def test_kernel_route_equals_its_plain_versions():
    """collide_stream with wk= is windkessel_flux_plain, then step_plain
    with the rho* it gives; the runner threads the same wk through its
    chunks."""
    cc = compile_case(get_case("coronary", **COR))
    f, wk, _ = _kernel_route(cc, 6)
    g = initial_f(cc)
    w = torch.from_numpy(wk_init(cc.bcs))
    for t in range(6):
        w, rho = K.windkessel_flux_plain(g, cc, w)
        g, _ = K.step_plain(g, cc, t, rho_wk=rho)
    assert torch.equal(f, g) and torch.equal(wk, w)
    sim = Simulation(get_case("coronary", **COR), device="cpu")
    sim.run(max_steps=6, time_save=4, verbose=False)
    assert torch.equal(sim.f, f) and torch.equal(sim.wk, wk)


def _flux_then_step(cc, f, w, steps, t0=0):
    """lbm_tpu's order: each step the outlets' flux from the pre-step
    state (windkessel_flux_plain), then the step with the rho* it
    gives."""
    for t in range(t0, t0 + steps):
        w, rho = K.windkessel_flux_plain(f, cc, w)
        f, _ = K.step_plain(f, cc, t, rho_wk=rho)
    return f, w


@pytest.fixture(scope="module")
def developed_coronary():
    """The pulsatile 4-outlet coronary after 80 float32 steps (flux, then
    step): a state whose every outlet has Q != 0 in both storages (a bf16
    state rounds the small flow of the first 60 steps at three outlets
    away), with its P_c."""
    cc = compile_case(get_case("coronary", **COR))
    f, w = _flux_then_step(cc, initial_f(cc),
                           torch.from_numpy(wk_init(cc.bcs)), 80)
    return cc, f, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_plain_equals_flux_then_step(developed_coronary, dtype):
    """The fold's plain sequence (prime, then each step's launch with the
    staged flux, committing P_c and staging the next) is bit for bit a
    flux from each pre-step state and the step, over 40 steps of the
    pulsatile 4-outlet coronary from a developed state; so is the kernel
    route's CPU twin."""
    cc, f_dev, w0 = developed_coronary
    f0 = f_dev.to(dtype)
    f, w = f0, w0.clone()
    _, q = K.wk_terms_plain(f, cc)
    assert (q != 0).all()
    for t in range(40):
        f, _, w, _, q = K.step_wk_plain(f, cc, t, w, q)
    g, v = _flux_then_step(cc, f0, w0.clone(), 40)
    assert torch.equal(f, g) and torch.equal(w, v) and (v != w0).all()
    h, out, u = f0.clone(), f0.clone(), w0.clone()
    series = torch.zeros(40, dtype=torch.float64)
    for t in range(40):
        K.step(h, out, cc, series, t, t, wk=u)
        h, out = out, h
    assert torch.equal(h, g) and torch.equal(u, v)


@pytest.mark.parametrize("how", ["set_f_standard", "restore"])
def test_pc_after_reload_equals_a_fresh_run(tmp_path, how):
    """A run whose state is loaded mid-way (set_f_standard with its P_c,
    or a checkpoint restore) primes the fold from the loaded state: its
    f and P_c after 8 more steps equal an uninterrupted run's."""
    spec = get_case("coronary", **COR)
    fresh = Simulation(spec, device="cpu")
    fresh.run(max_steps=16, time_save=8, verbose=False)
    a = Simulation(spec, device="cpu")
    a.run(max_steps=8, time_save=8, verbose=False)
    b = Simulation(spec, device="cpu")
    if how == "restore":
        path = str(tmp_path / "mid.npz")
        ckpt.save_sim(path, a)
        ckpt.restore(b, path)
    else:
        b.run(max_steps=3, time_save=3, verbose=False)  # a staged state
        b.set_f_standard(a.f_standard())
        b.wk, b.t = a.wk.clone(), a.t
    b.run(max_steps=8, time_save=8, verbose=False)
    assert torch.equal(b.f, fresh.f) and torch.equal(b.wk, fresh.wk)


def test_direct_calls_prime_on_another_state():
    """A direct call whose f is not the last fold launch's out (another
    state, or the same one written in place) primes the fold from f: two
    runs of one case interleaved call by call, and a state scaled in
    place between calls, each equal to its own plain sequence."""
    cc = compile_case(get_case("coronary", **COR))
    w0 = torch.from_numpy(wk_init(cc.bcs))
    f0 = initial_f(cc)
    f1 = f0 * 1.001
    runs = [[f0.clone(), f0.clone(), w0.clone()],
            [f1.clone(), f1.clone(), w0.clone()]]
    series = torch.zeros(1, dtype=torch.float64)
    for t in range(6):
        for r in runs:
            K.step(r[0], r[1], cc, series, 0, t, wk=r[2])
            r[0], r[1] = r[1], r[0]
    for r, start in zip(runs, (f0, f1)):
        g, v = _flux_then_step(cc, start, w0.clone(), 6)
        assert torch.equal(r[0], g) and torch.equal(r[2], v)
    h, out, u = runs[0]
    h.mul_(1.0005)  # in place: torch bumps its version
    w_before, h_before = u.clone(), h.clone()
    K.step(h, out, cc, series, 0, 6, wk=u)
    w, rho = K.windkessel_flux_plain(h_before, cc, w_before)
    g, _ = K.step_plain(h_before, cc, 6, rho_wk=rho)
    assert torch.equal(out, g) and torch.equal(u, w)


@pytest.mark.parametrize("name,kw", [("coronary", COR),
                                     ("poiseuille", POIS)])
def test_fold_list_holds_the_fluid_cells_footprint_first(name, kw):
    """The launch list of a case with windkessel outlets holds the same
    cells as fluid_cell_ids, the outlets' fluid footprint cells first in
    footprint order (the rest ascending), even where a case without
    outlets would launch over every cell; WKLists.foot names their
    footprint rows and axes."""
    cc = compile_case(get_case(name, **kw))
    mask = np.asarray(cc.spec.mask)
    ids = cc.fluid_cells.numpy()
    assert sorted(ids.tolist()) == fluid_cell_ids(mask).tolist()
    fluid = mask.reshape(-1) == 4
    wk = [bc for bc in cc.bcs if bc.windkessel is not None]
    foot = np.concatenate([wk_footprint(bc, cc.shape)[0] for bc in wk])
    head = foot[fluid[foot]]
    assert 0 < len(head) < len(ids)
    assert ids[:len(head)].tolist() == head.tolist()
    rest = ids[len(head):]
    assert (np.diff(rest) > 0).all() and not np.isin(rest, head).any()
    lists = K.wk_lists(cc)
    codes = lists.foot.numpy()
    assert lists.cells.numpy()[codes // 3].tolist() == head.tolist()
    axes = np.repeat([bc.axis for bc in wk], np.diff(lists.rows[:, 1:],
                                                     axis=1)[:, 0])
    assert (codes % 3 == axes[codes // 3]).all()


def _kernel_order_sum(v: np.ndarray, block: int = K.WK_BLOCK) -> np.float32:
    """The flux kernel's order, written out in NumPy fp32: thread j sums
    v[j], v[j + block], ... from 0, then the partials add in a halving
    tree."""
    part = np.zeros(block, np.float32)
    for j in range(block):
        acc = np.float32(0.0)
        for x in v[j::block]:
            acc = np.float32(acc + x)
        part[j] = acc
    s = block // 2
    while s:
        part[:s] = (part[:s] + part[s:2 * s]).astype(np.float32)
        s //= 2
    return part[0]


def test_flux_plain_sums_in_the_kernels_order():
    """windkessel_flux_plain's Q sums in the kernel's fixed order (a
    footprint longer than a block), and its P_c' is the dense twin's
    within fp32 rounding of the sum."""
    cc = compile_case(get_case("coronary", shape=(64, 40, 64), radius=10,
                               windkessel=WK4))
    lists = K.wk_lists(cc)
    assert (lists.rows[:, 2] - lists.rows[:, 1]).max() > K.WK_BLOCK
    rng = np.random.default_rng(3)
    f = initial_f(cc) * torch.from_numpy(
        rng.uniform(0.98, 1.02, (19,) + cc.shape).astype(np.float32))
    wk = torch.from_numpy(rng.uniform(0, 1e-3, 4).astype(np.float32))
    p_new, rho = K.windkessel_flux_plain(f, cc, wk)
    flat = f.reshape(19, -1).numpy()
    for k, (axis, b0, b1) in enumerate(lists.rows):
        pop = flat[:, lists.cells[b0:b1].numpy()]
        rho_c = pop[0].copy()
        for i in range(1, 19):
            rho_c = (rho_c + pop[i]).astype(np.float32)
        m = None
        for i in range(19):
            s = D3Q19.E[i][axis]
            if s == 0:
                continue
            term = pop[i] if s > 0 else -pop[i]
            m = term if m is None else (m + term).astype(np.float32)
        u = (m / np.where(rho_c == 0, 1, rho_c)).astype(np.float32)
        v = (lists.weights[b0:b1].numpy() * u).astype(np.float32)
        q = np.float32(lists.floats[k][0]) * _kernel_order_sum(v)
        want, want_in = windkessel_update(wk[k], torch.tensor(q),
                                          cc.bcs[1 + k].windkessel)
        assert p_new[k].item() == want.item()
        assert rho[k].item() == (np.float32(1.0)
                                 + np.float32(3.0) * want_in.item())
    _, dense = pulled_state_wk(cc, f, 0, wk)
    np.testing.assert_allclose(p_new.numpy(), dense.numpy(), rtol=1e-5)


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_lbm_tpu_checkpoint_restores_and_continues(tmp_path, backend):
    """An lbm_tpu save_sim with wk restores into the port and 20 more
    steps there equal 20 more in lbm_tpu; the port's own file round
    trips."""
    ref = RefSimulation(ref_get_case("coronary", **COR), backend="xla")
    ref.run(max_steps=20, time_save=20, verbose=False)
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save_sim(path, ref)
    sim = Simulation(get_case("coronary", **COR), device="cpu",
                     backend=backend)
    ckpt.restore(sim, path)
    np.testing.assert_array_equal(sim.wk.numpy(), np.asarray(ref.wk))
    assert sim.t == 20
    for s in (ref, sim):
        s.run(max_steps=20, time_save=20, verbose=False)
    _close(sim.f_standard(), ref.f_standard())
    _close(sim.wk, ref.wk)
    mine = str(tmp_path / "port.npz")
    ckpt.save_sim(mine, sim)
    back = Simulation(get_case("coronary", **COR), device="cpu",
                      backend=backend)
    ckpt.restore(back, mine)
    assert torch.equal(back.wk, sim.wk) and torch.equal(back.f, sim.f)
    ref2 = RefSimulation(ref_get_case("coronary", **COR), backend="xla")
    ref_ckpt.restore(ref2, mine)
    np.testing.assert_array_equal(np.asarray(ref2.wk), sim.wk.numpy())
    plain = Simulation(get_case("coronary", shape=(48, 24, 40), radius=5),
                       device="cpu")
    with pytest.raises(ValueError, match="no windkessel outlets"):
        ckpt.restore(plain, mine)


def test_coupled_transport_matches_lbm_tpus():
    """CoupledTransport with four RCR outlets, dense route, against
    lbm_tpu's CoupledTransport: g, the carried P_c and the records; the
    kernel route carries the same P_c as its flow (div_fix off) and
    records against lbm_tpu's dense class without div_fix (the kernel
    route has none) at rtol 1e-4: its velocity is rebuilt from the
    post-collision state, equal in exact arithmetic."""
    inlet = {0: 1.0}
    ref = RefCoupled(ref_get_case("coronary", **COR), D=0.02, inlet_c=inlet)
    rec = ref.run(12, record=[0, 1, 2])
    tr = CoupledTransport(get_case("coronary", **COR), D=0.02,
                          inlet_c=inlet, device="cpu", backend="dense")
    mine = tr.run(12, record=[0, 1, 2])
    np.testing.assert_allclose(tr.g.numpy(), np.asarray(ref.g), rtol=1e-5,
                               atol=1e-7)
    _close(tr.wk, ref.wk)
    np.testing.assert_allclose(mine, np.asarray(rec), rtol=1e-5, atol=1e-7)
    _close(tr.f, ref.f)
    kern = CoupledTransport(get_case("coronary", **COR), D=0.02,
                            inlet_c=inlet, device="cpu")
    krec = kern.run(12, record=[0, 1, 2])
    _close(kern.wk, ref.wk)
    _close(kern.f, ref.f)
    ref0 = RefCoupled(ref_get_case("coronary", **COR), D=0.02,
                      inlet_c=inlet, div_fix=False)
    rec0 = ref0.run(12, record=[0, 1, 2])
    np.testing.assert_allclose(krec, np.asarray(rec0), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(kern.g.numpy(), np.asarray(ref0.g),
                               rtol=1e-4, atol=1e-7)


def test_bf16_storage_takes_windkessel_outlets():
    """bf16 storage runs windkessel cases, as lbm_tpu's Pallas path does:
    a step is the fp32 step of the widened state, narrowed once, and the
    run stays within lbm_tpu's bf16 bound (2e-2 of max |f|) of its fp32
    dense route."""
    cc = compile_case(get_case("coronary", **COR))
    f = initial_f(cc).to(torch.bfloat16)
    out, out32 = f.clone(), f.float().clone()
    w16 = torch.from_numpy(wk_init(cc.bcs))
    w32 = w16.clone()
    series = torch.zeros(1, dtype=torch.float64)
    K.step(f, out, cc, series, 0, 0, wk=w16)
    K.step(f.float(), out32, cc, series, 0, 0, wk=w32)
    assert torch.equal(out, out32.to(torch.bfloat16))
    assert torch.equal(w16, w32)
    ref = RefSimulation(ref_get_case("coronary", **COR), backend="xla")
    ref.run(max_steps=4, time_save=4, verbose=False)
    sim = Simulation(get_case("coronary", **COR), device="cpu",
                     store_dtype="bf16")
    sim.run(max_steps=4, time_save=4, verbose=False)
    f_ref = np.asarray(ref.f_standard())
    rel = np.abs(sim.f_standard().numpy() - f_ref).max() / np.abs(f_ref).max()
    assert 0 < rel < 2e-2, rel


def test_refusals():
    spec = get_case("poiseuille", **POIS)
    with pytest.raises(ValueError, match="fuse=2 requires a single-chip run"):
        Simulation(spec, device="cpu", fuse=2)
    mesh = LatticeMesh(group=None, rank=0, world=1,
                       device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="does not thread the windkessel"):
        Simulation(spec, device="cpu", mesh=mesh)
    # the dense backend's GSPMD windkessel route: a ring of one is the
    # unsharded run, bit for bit off the DEAD cells, P_c too
    runs = [Simulation(spec, device="cpu", backend="dense", mesh=m)
            for m in (mesh, None)]
    for sim in runs:
        sim.run(max_steps=6, time_save=3, verbose=False)
    live = np.asarray(spec.mask) != CellType.DEAD
    assert torch.equal(runs[0].f_standard()[:, live],
                       runs[1].f_standard()[:, live])
    assert torch.equal(runs[0].wk, runs[1].wk)
    cc = compile_case(spec)
    with pytest.raises(ValueError, match="make_step_wk"):
        make_step(cc)
    with pytest.raises(ValueError, match="runtime-force step"):
        make_step_force(cc)
    f = initial_f(cc)
    series = torch.zeros(1, dtype=torch.float64)
    with pytest.raises(ValueError, match="carried P_c"):
        K.step(f, f.clone(), cc, series, 0, 0)
    with pytest.raises(ValueError, match="carried P_c"):
        K.step(f, f.clone(), cc, series, 0, 0, wk=torch.zeros(2))
    plain = compile_case(get_case("poiseuille", n=16))
    with pytest.raises(ValueError, match="without windkessel"):
        K.step(initial_f(plain), initial_f(plain), plain, series, 0, 0,
               wk=torch.zeros(1))
    with pytest.raises(ValueError, match="runtime-force step"):
        CoupledTransport(get_case("coronary", **COR), D=0.02, device="cpu",
                         field=K.ForceField((0.0, 0.0, 1e-5)))


def test_windkessel_plane_meeting_another_boundary_is_refused():
    """lbm_tpu fixes a windkessel plane after its kernel's static planes,
    the kernel here applies every plane in one pass in boundary order:
    the two agree when the windkessel plane shares no consumer cell with
    another boundary. The coronary's outlets pass (the small box's too,
    where a sub-outlet's consumer cells lie on the main outlet's plane);
    its main x outlet moved onto the inlet's consumer plane is refused,
    and a z outlet whose window holds another plane's cells."""
    for kw in (COR, dict(COR, shape=(24, 20, 32), radius=4)):
        cc = compile_case(get_case("coronary", **kw))
        check_z_windows(cc.bcs, cc.shape)
    cc = compile_case(get_case("coronary", **COR))
    bcs = list(cc.bcs)
    bcs[1] = dataclasses.replace(bcs[1], consumer_coord=bcs[0].consumer_coord)
    with pytest.raises(ValueError,
                       match="boundary 0 rewrites consumer cells of "
                             "windkessel boundary 1 on x=4"):
        check_z_windows(bcs, cc.shape)
    bcs = list(cc.bcs)
    bcs[2] = dataclasses.replace(bcs[2], consumer_coord=8,
                                 window=(0, 48, 0, 24))
    with pytest.raises(ValueError, match="boundary 0 rewrites cells inside"):
        check_z_windows(bcs, cc.shape)


def test_fold_refuses_all_blocks_naming_the_footprint_first():
    """A case with windkessel outlets launches the fold over its fluid-cell
    list, whose head is the outlets' footprint cells (compile.
    fold_cell_ids): the refusal of all_blocks says so."""
    cc = compile_case(get_case("coronary", **COR))
    f = initial_f(cc)
    wk = torch.from_numpy(wk_init(cc.bcs))
    series = torch.zeros(1, dtype=torch.float64)
    with pytest.raises(ValueError, match=(
            "launches over its fluid-cell list, the outlets' footprint "
            "cells first \\(compile.fold_cell_ids\\)")):
        K.collide_stream(f, f.clone(), cc, series, 0, 0, all_blocks=True,
                         wk=wk)
    head = np.concatenate([wk_footprint(bc, cc.shape)[0] for bc in cc.bcs
                           if bc.windkessel is not None])
    fluid = np.asarray(cc.spec.mask).reshape(-1) == CellType.FLUID
    head = head[fluid[head]]
    np.testing.assert_array_equal(cc.fluid_cells[:len(head)].numpy(), head)
