"""The immersed-boundary port (lbm_tpu_torch/engine/ibm.py) held against
lbm_tpu on the CPU: the delta's support (its floored wrap on negative
indices), interpolation and spreading alone, the IBM step's states after
20 steps (static, moving and TRT cases, one and two forcing sweeps), the
bridge, the MRT refusal, and lbm_tpu's own physics assertions on the
port's longer runs (tests/test_ibm.py).

Tolerance: rtol 3e-6 / atol 1e-7 on f; interp sums 64 products in another
order than XLA's reduction: rtol 1e-6 there; spread is index_add_ in index
order, XLA's scatter-add on the CPU the same: bit for bit. u: atol 5e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core.units import UnitSystem
from lbm_tpu.engine import ibm as ref_ibm
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.spec import CaseSpec as RefCaseSpec
from lbm_tpu.geometry.mask import CellType
from lbm_tpu_torch import bridge
from lbm_tpu_torch.engine import ibm
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.ibm import IBMFlow, make_ibm_step, marker_plane

_UNITS = UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0)


@pytest.fixture(autouse=True)
def _torch_one_thread():
    """The boxes are tiny: torch's intra-op threads would only contend with
    the other test workers' for the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(shape, tau=1.0, force=None, **extra):
    mask = np.full(shape, int(CellType.FLUID), np.int32)
    ref = RefCaseSpec(name="ibm_box", shape=shape, tau=tau, units=_UNITS,
                      mask=mask, boundaries=[], force=force, **extra)
    return ref, bridge.case_from_reference(ref)


def _close(got, want, rtol=3e-6, atol=1e-7):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


MARKERS = {
    "inside": [[5.0, 6.0, 7.0], [4.3, 5.7, 8.2], [3.14, 7.9, 3.5]],
    # stencils reaching below 0 and past the far side: the floored wrap
    "edges": [[0.2, 0.9, 15.6], [11.7, 0.0, 0.4], [1.5, 11.99, 14.5]],
    "negative": [[-0.6, 3.3, -1.2], [-2.5, -0.01, 5.0]],
}


@pytest.mark.parametrize("name", sorted(MARKERS))
def test_support_interp_spread_match_lbm_tpu(name):
    """_support's indices equal and weights bit for bit (torch.remainder
    is jnp.mod's floored modulo), interp (rtol 1e-6) and spread (bit for
    bit) on seeded fields and forces, total force conserved."""
    shape = (12, 12, 16)
    Xm = np.asarray(MARKERS[name], np.float32)
    rflat, rw = ref_ibm._support(jnp.asarray(Xm), shape)
    flat, w = ibm._support(torch.from_numpy(Xm), shape)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(rflat))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
    assert int(flat.min()) >= 0 and int(flat.max()) < np.prod(shape)
    rng = np.random.default_rng(3)
    field = rng.standard_normal((3,) + shape).astype(np.float32)
    _close(ibm.interp(torch.from_numpy(field), flat, w),
           ref_ibm.interp(jnp.asarray(field), rflat, rw), 1e-6, 1e-7)
    Fm = rng.standard_normal((len(Xm), 3)).astype(np.float32)
    F = ibm.spread(torch.from_numpy(Fm), flat, w, shape)
    np.testing.assert_array_equal(
        F.numpy(), np.asarray(ref_ibm.spread(jnp.asarray(Fm), rflat, rw,
                                             shape)))
    np.testing.assert_allclose(F.sum(dim=(1, 2, 3)).numpy(), Fm.sum(0),
                               rtol=1e-5, atol=1e-6)


def test_delta_partition_and_linear_exactness():
    """Peskin's delta on the port: weights sum to 1 and interpolate a
    linear field exactly (lbm_tpu's anchor)."""
    shape = (12, 12, 16)
    x, y, z = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in shape),
                          indexing="ij")
    lin = torch.from_numpy((2.0 + 0.5 * x + 0.25 * y - 0.125 * z)[None])
    Xm = torch.tensor(MARKERS["inside"], dtype=torch.float32)
    flat, w = ibm._support(Xm, shape)
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-6)
    want = 2.0 + 0.5 * Xm[:, 0] + 0.25 * Xm[:, 1] - 0.125 * Xm[:, 2]
    np.testing.assert_allclose(ibm.interp(lin, flat, w)[:, 0].numpy(),
                               want.numpy(), rtol=2e-6)


def _moving(plates):
    """A plate oscillating in x and drifting in z: (X_of_t, U_of_t) as
    NumPy callables of the integer step, and lbm_tpu's traced ones."""
    def X_np(t):
        out = plates.copy()
        out[:, 2] += np.float32(0.01) * np.float32(t)
        return out

    def U_np(t):
        u = np.zeros_like(plates)
        u[:, 0] = np.float32(0.02) * np.cos(np.float32(0.1) * np.float32(t))
        u[:, 2] = np.float32(0.01)
        return u

    X0 = jnp.asarray(plates)

    def X_j(t):
        return X0.at[:, 2].add(np.float32(0.01) * t.astype(jnp.float32))

    def U_j(t):
        ux = np.float32(0.02) * jnp.cos(
            np.float32(0.1) * t.astype(jnp.float32))
        n = X0.shape[0]
        return jnp.stack([jnp.full((n,), ux), jnp.zeros(n),
                          jnp.full((n,), np.float32(0.01))], axis=1)

    return (X_np, U_np), (X_j, U_j)


@pytest.mark.parametrize("collision,n_iter,force,moving", [
    ("bgk", 2, (1e-5, 0.0, 0.0), False),
    ("bgk", 1, (1e-5, 0.0, 0.0), False),
    ("trt", 2, (1e-5, 0.0, 0.0), False),
    ("bgk", 2, None, True),
])
def test_ibm_flow_matches_lbm_tpu(collision, n_iter, force, moving):
    """IBMFlow against lbm_tpu's over 20 steps: f, rho and u (the moving
    plate's cos rounds in numpy on the port's side and in XLA on lbm_tpu's:
    rtol 1e-5 there)."""
    shape = (6, 6, 24)
    extra = {} if collision == "bgk" else dict(collision="trt",
                                               magic_lambda=0.1875)
    rspec, spec = _boxes(shape, tau=0.8, force=force, **extra)
    plates = np.concatenate([marker_plane(2.0, 2, shape),
                             marker_plane(14.3, 2, shape)])
    motion, rmotion = _moving(plates) if moving else (None, None)
    ref = ref_ibm.IBMFlow(rspec, plates, n_iter=n_iter, motion=rmotion)
    flow = IBMFlow(spec, plates, n_iter=n_iter, motion=motion, device="cpu")
    ref.run(20)
    flow.run(20)
    assert flow.t == ref.t == 20
    rtol = 1e-5 if moving else 3e-6
    _close(flow.f, ref.f, rtol)
    rho, u = flow.macro()
    rrho, ru = ref.macro()
    _close(rho, rrho, rtol)
    _close(u, ru, 0, 5e-7)
    assert float(u[0].abs().max()) > 1e-6


def test_ibm_step_forces_and_bridge():
    """make_ibm_step's returned grid force and moments from a developed
    lbm_tpu state carried over by the bridge, and the state back."""
    shape = (6, 6, 16)
    rspec, spec = _boxes(shape, tau=1.0, force=(1e-5, 0.0, 0.0))
    plates = np.concatenate([marker_plane(2.0, 2, shape),
                             marker_plane(10.0, 2, shape)])
    ref = ref_ibm.IBMFlow(rspec, plates)
    ref.run(30)
    flow = IBMFlow(spec, plates, device="cpu")
    bridge.load_lattice_state(flow, bridge.lattice_state_from_reference(ref))
    step = make_ibm_step(compile_case(spec), n_iter=2)
    rstep = jax.jit(ref_ibm.make_ibm_step(ref_compile_case(rspec), n_iter=2))
    Xm = torch.from_numpy(plates)
    f, rho, u, F = step(flow.f, flow.t, Xm, torch.zeros_like(Xm))
    rf, rrho, ru, rF = rstep(ref.f, jnp.int32(ref.t), jnp.asarray(plates),
                             jnp.zeros_like(jnp.asarray(plates)))
    _close(f, rf)
    _close(rho, rrho)
    _close(u, ru, 0, 5e-7)
    _close(F, rF, 1e-5, 1e-10)
    flow.run(5)
    back = bridge.lattice_state_to_numpy(flow)
    ref.f, ref.t = jnp.asarray(back["f"]), back["t"]
    ref.run(5)
    flow.run(5)
    _close(flow.f, ref.f)


def test_ibm_refuses_mrt():
    _, spec = _boxes((6, 6, 8), collision="mrt")
    with pytest.raises(ValueError, match="MRT \\+ field force is not wired"):
        make_ibm_step(compile_case(spec))


def test_ibm_multi_direct_forcing_tightens_noslip():
    """lbm_tpu's multi-direct-forcing anchor on the port: the second sweep
    cuts the no-slip defect below 0.6 of one sweep's."""
    shape = (6, 6, 24)
    _, spec = _boxes(shape, tau=1.0, force=(1e-5, 0.0, 0.0))
    plates = np.concatenate([marker_plane(2.0, 2, shape),
                             marker_plane(14.0, 2, shape)])
    Xm = torch.from_numpy(plates)
    defects = []
    for n_iter in (1, 2):
        flow = IBMFlow(spec, plates, n_iter=n_iter, device="cpu")
        flow.run(600)
        step = make_ibm_step(flow.cc, n_iter=n_iter)
        _, _, u, _ = step(flow.f, flow.t, Xm, torch.zeros_like(Xm))
        flat, w = ibm._support(Xm, shape)
        defects.append(float(ibm.interp(u, flat, w).abs().max()))
    assert defects[1] < 0.6 * defects[0], defects


def test_ibm_stokes_second_problem_envelope():
    """lbm_tpu's Stokes anchor on the port: the oscillating plate's
    boundary-layer amplitude decays as e^{-k dz}, k = sqrt(omega/(2 nu)),
    within 5%, the effective origin within 1.2 cells."""
    shape = (4, 4, 48)
    tau = 0.8
    nu = (tau - 0.5) / 3.0
    period = 500
    omega = 2.0 * np.pi / period
    k = np.sqrt(omega / (2.0 * nu))
    U0, zp = 0.02, 24.0
    _, spec = _boxes(shape, tau=tau)
    plate = marker_plane(zp, 2, shape)

    def U_of_t(t):
        u = np.zeros_like(plate)
        u[:, 0] = np.float32(U0) * np.cos(np.float32(omega) * np.float32(t))
        return u

    flow = IBMFlow(spec, plate, motion=(lambda t: plate, U_of_t),
                   device="cpu")
    flow.run(2 * period)
    samples = []
    for _ in range(10):
        flow.run(period // 10)
        samples.append(flow.macro()[1][0][2, 2, :].numpy())
    amp = (np.max(samples, axis=0) - np.min(samples, axis=0)) / 2.0
    dz = np.arange(shape[2], dtype=np.float64) - zp
    sel = (dz >= 2.0) & (dz <= 8.0)
    slope, icpt = np.polyfit(dz[sel], np.log(amp[sel]), 1)
    np.testing.assert_allclose(-slope, k, rtol=0.05)
    assert abs((icpt - np.log(U0)) / k) < 1.2


def test_ibm_plates_poiseuille_profile():
    """lbm_tpu's channel anchor on the port: body-forced flow between two
    static plates relaxes to a parabola of curvature -g/nu (3%) whose
    effective walls sit within 1.2 cells of the marker planes, with a
    small no-slip defect."""
    g, z0, z1 = 1e-5, 2.0, 14.0
    shape = (6, 6, 24)
    _, spec = _boxes(shape, tau=1.0, force=(g, 0.0, 0.0))
    plates = np.concatenate([marker_plane(z0, 2, shape),
                             marker_plane(z1, 2, shape)])
    flow = IBMFlow(spec, plates, n_iter=2, device="cpu")
    flow.run(2500)
    ux = flow.macro()[1][0][3, 3, :].double().numpy()
    nu = (spec.tau - 0.5) / 3.0
    z = np.arange(shape[2], dtype=np.float64)
    zin = (z > z0 + 1.5) & (z < z1 - 1.5)
    coef = np.polyfit(z[zin], ux[zin], 2)
    assert np.abs(np.polyval(coef, z[zin]) - ux[zin]).max() < 0.01 * ux[
        zin].max()
    np.testing.assert_allclose(2.0 * coef[0], -g / nu, rtol=0.03)
    r1, r2 = sorted(np.roots(coef).real)
    assert abs(r1 - z0) < 1.2 and abs(r2 - z1) < 1.2, (r1, r2)
    Xm = torch.from_numpy(plates)
    _, _, u, _ = make_ibm_step(flow.cc, n_iter=2)(flow.f, flow.t, Xm,
                                                 torch.zeros_like(Xm))
    flat, w = ibm._support(Xm, shape)
    assert float(ibm.interp(u, flat, w).abs().max()) < 0.05 * ux.max()
