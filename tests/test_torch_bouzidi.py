"""Bouzidi curved walls in lbm_tpu_torch on the CPU, held against
lbm_tpu: link_q and the coefficients bit for bit; the dense step (BGK,
TRT, the curved coronary with its inlet and four outlets, windkessel
outlets too) against lbm_tpu's 'xla' step at lbm_tpu's own sparse/dense
Bouzidi tolerance (f at fluid cells, rtol 3e-6 / atol 1e-7,
tests/test_bouzidi.py), P_c at the windkessel tests' rtol 3e-5 / atol
1e-8, velsum at 1e-5 relative; q = 1/2 everywhere is half-way
bounce-back bit for bit; the dense halo step's shards equal the whole
box bit for bit; the stress outputs through the curved pull."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.core.bouzidi import bouzidi_coeffs as ref_bouzidi_coeffs
from lbm_tpu.core.bouzidi import link_q as ref_link_q
from lbm_tpu.engine import stress as ref_stress
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.engine.step import initial_f as ref_initial_f
from lbm_tpu.engine.step import make_step as ref_make_step
from lbm_tpu.engine.step import make_step_wk as ref_make_step_wk
from lbm_tpu_torch.bridge import case_from_reference
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.core.bouzidi import bouzidi_coeffs, link_q, link_table
from lbm_tpu_torch.engine import stress
from lbm_tpu_torch.engine.compile import compile_case, compile_shard, wk_init
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.step import (
    initial_f,
    make_step,
    make_step_wk,
    pulled_state,
    step_tail,
)
from lbm_tpu_torch.parallel.halo import ring_planes

RTOL, ATOL = 3e-6, 1e-7            # lbm_tpu's Bouzidi sparse/dense bound
WK_RTOL, WK_ATOL = 3e-5, 1e-8      # lbm_tpu's windkessel bound
WK4 = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3), (1e-4, 5e3, 4e-3),
       (1e-4, 5e3, 8e-3)]
PIPE = dict(n=20, nz=4, radius=5.6)
CURVED_COR = dict(shape=(48, 24, 40), radius=5, curved=True)
CASES = {
    "pipe": ("pipe", PIPE),
    "pipe_trt": ("pipe", dict(PIPE, collision="trt")),
    "coronary": ("coronary", CURVED_COR),
    "coronary_wk": ("coronary", dict(CURVED_COR, windkessel=WK4,
                                     pulsatile=(4, 8))),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: small boxes in parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fluid(spec):
    return np.asarray(spec.mask) == 4


@pytest.mark.parametrize("name,kw", [
    ("pipe", PIPE), ("pipe", dict(n=36, nz=4, radius=13.7)),
    ("coronary", CURVED_COR),
    ("coronary", dict(shape=(64, 32, 48), radius=6, curved=True)),
])
def test_link_q_is_lbm_tpus_bit_for_bit(name, kw):
    ref = ref_get_case(name, **kw)
    mask = np.asarray(ref.mask)
    want = ref_link_q(mask, ref.wall_sdf)
    got = link_q(mask, ref.wall_sdf)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    # real fractional distances, both fallbacks exercised
    assert (np.abs(got - 0.5) > 0.05).sum() > 100
    table = link_table(mask, ref.wall_sdf)
    for j, (ids, q) in enumerate(table):
        assert np.array_equal(q, want[j].ravel()[ids])
    # the coefficients, in float32, as lbm_tpu's step computes them
    for mine, theirs in zip(bouzidi_coeffs(torch.from_numpy(got)),
                            ref_bouzidi_coeffs(jnp.asarray(want))):
        assert mine.dtype == torch.float32
        assert np.array_equal(mine.numpy(), np.asarray(theirs))


def test_link_q_fallbacks():
    """q_min clipping, the far-fluid fallback and an sdf the labels
    contradict, on a hand-built slab, bit for bit lbm_tpu's."""
    rng = np.random.default_rng(3)
    mask = np.full((10, 8, 6), 4, np.int32)
    mask[:2] = 1
    mask[6:8] = 1
    mask[8:] = 0
    mask[4, 3, 2] = 1                  # a one-cell obstacle
    sdf = rng.normal(0.0, 2.0, mask.shape).astype(np.float32)
    sdf[5] = 0.0                       # denominators of zero
    want = ref_link_q(mask, sdf)
    assert np.array_equal(link_q(mask, sdf), want)
    assert np.array_equal(link_q(mask, sdf, q_min=0.2),
                          ref_link_q(mask, sdf, q_min=0.2))
    assert (want == np.float32(1e-3)).any() and (want == 1.0).any()


def _ref_dense(rs, steps, wk=None):
    cc = ref_compile_case(rs)
    f = ref_initial_f(cc)
    if wk is None:
        step = jax.jit(ref_make_step(cc))
        for t in range(steps):
            f, _, _ = step(f, jnp.int32(t))
        return np.asarray(f), None
    step = jax.jit(ref_make_step_wk(cc))
    for t in range(steps):
        f, _, _, wk = step(f, jnp.int32(t), wk)
    return np.asarray(f), np.asarray(wk)


def _port_dense(spec, steps):
    cc = compile_case(spec)
    f = initial_f(cc)
    w0 = wk_init(cc.bcs)
    if w0 is None:
        step = make_step(cc)
        for t in range(steps):
            f, _, _ = step(f, t)
        return f.numpy(), None
    wk = torch.from_numpy(w0)
    step = make_step_wk(cc)
    for t in range(steps):
        f, _, _, wk = step(f, t, wk)
    return f.numpy(), wk.numpy()


@pytest.mark.parametrize("label", sorted(CASES))
def test_dense_bouzidi_step_matches_lbm_tpu_xla(label):
    """6 steps (the windkessel case 40, until its P_c is above rounding)
    of the dense step with curved walls against lbm_tpu's dense step."""
    name, kw = CASES[label]
    rs = ref_get_case(name, **kw)
    spec = case_from_reference(rs)
    steps = 40 if "windkessel" in kw else 6
    w0 = None
    if "windkessel" in kw:
        w0 = jnp.asarray([b.windkessel_p0 for b in rs.boundaries
                          if b.windkessel is not None], jnp.float32)
    f_ref, wk_ref = _ref_dense(rs, steps, w0)
    f, wk = _port_dense(spec, steps)
    fl = _fluid(spec)
    np.testing.assert_allclose(f[:, fl], f_ref[:, fl], rtol=RTOL, atol=ATOL)
    assert np.isfinite(f).all()
    if wk is not None:
        np.testing.assert_allclose(wk, wk_ref, rtol=WK_RTOL, atol=WK_ATOL)
        assert np.abs(wk).max() > 1e-4


def test_q_half_is_halfway_bounce_back_bit_for_bit():
    """A planar sdf that puts every crossing half-way gives the staircase
    step bit for bit (coefficients (1, 0, 0)), as lbm_tpu's test holds."""
    n = 16
    spec = get_case("gravity_channel", n=n, nz=4)
    x = np.arange(n, dtype=np.float64)
    d = np.minimum(np.minimum(x - 1.5, n - 2.5 - x)[:, None],
                   np.minimum(x - 1.5, n - 2.5 - x)[None, :])
    sdf = np.repeat(d.astype(np.float32)[:, :, None], 4, axis=2)
    curved = dataclasses.replace(spec, wall_sdf=sdf)
    assert compile_case(curved).bouzidi is not None
    f_plain, _ = _port_dense(spec, 5)
    f_bz, _ = _port_dense(curved, 5)
    assert np.array_equal(f_bz, f_plain)


def test_dense_run_velsum_matches_lbm_tpu():
    """Simulation(backend='dense') on the curved coronary against lbm_tpu's
    Simulation(backend='xla'): a chunk's per-step velsum samples at 1e-5
    relative, f at fluid cells at the step bound. (The force-driven pipe's
    |u| ~ 1e-4 leaves its velsum to the populations' rounding: lbm_tpu's
    own two backends differ there by 1e-4.)"""
    rs = ref_get_case("coronary", **CURVED_COR)
    ref = RefSimulation(rs, backend="xla")
    ref.f, _, s_ref = ref._build_chunk(24)(ref.f, jnp.int32(0))
    sim = Simulation(case_from_reference(rs), device="cpu", backend="dense")
    samples = np.concatenate([sim._advance(8) for _ in range(3)])
    np.testing.assert_allclose(samples, np.asarray(s_ref), rtol=1e-5)
    fl = _fluid(rs)
    np.testing.assert_allclose(sim.f.numpy()[:, fl],
                               np.asarray(ref.f)[:, fl], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name,kw,axis,world", [
    ("pipe", dict(n=20, nz=8, radius=5.6), 2, 2),
    ("coronary", CURVED_COR, 1, 3),
])
def test_halo_shards_equal_the_whole_box(name, kw, axis, world):
    """The dense halo step with curved walls: each shard's links take the
    whole box's q, and opp(i)'s pull across the shard's faces reads the
    neighbours' planes, so the shards stepped in one process are the
    whole box's dense step bit for bit."""
    spec = get_case(name, **kw)
    cc = compile_case(spec)
    f = initial_f(cc)
    step = make_step(cc)
    shards = [compile_shard(spec, r, world, axis) for r in range(world)]
    rows = shards[0].shape[axis]
    parts = [f.narrow(1 + axis, r * rows, rows).clone()
             for r in range(world)]
    for t in range(4):
        f, _, _ = step(f, t)
        planes = ring_planes(parts, axis)
        parts = [step_tail(c, p, pulled_state(c, p, t,
                                              halo=c.halo(*planes[r])))[0]
                 for r, (c, p) in enumerate(zip(shards, parts))]
    assert torch.equal(torch.cat(parts, dim=1 + axis), f)


def test_curved_stress_and_wss_match_lbm_tpu():
    """stress_fields and wss_field through the curved pull (with the SDF
    normals) against lbm_tpu's, from a state 30 steps in."""
    rs = ref_get_case("pipe", **PIPE)
    ref = RefSimulation(rs, backend="xla")
    ref.f, _, _ = ref._build_chunk(30)(ref.f, jnp.int32(0))
    ref.t = 30
    sim = Simulation(case_from_reference(rs), device="cpu", backend="dense")
    sim.set_f_standard(np.asarray(ref.f))
    sim.t = ref.t
    sig, _, _ = sim.stress()
    sig_ref, _, _ = ref.stress()
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_ref), rtol=1e-4,
                               atol=1e-9)
    w = sim.wss().numpy()
    w_ref = np.asarray(ref.wss())
    assert (w != 0).sum() == (w_ref != 0).sum() > 50
    np.testing.assert_allclose(w, w_ref, rtol=1e-4, atol=1e-9)
    normals = stress.wall_normals(rs.mask, rs.wall_sdf)
    assert np.array_equal(normals, ref_stress.wall_normals(rs.mask,
                                                           rs.wall_sdf))
