"""The scalar and thermal kernel route's plain versions (what the CUDA
kernels are held against on the card) against lbm_tpu's Pallas classes in
interpret mode: ScalarTransportPallas (K7), CoupledTransportPallas (K8)
and BuoyantTransportPallas (K1e + K8), and their packed states carried
across the bridge.

lbm_tpu's kernel route keeps plain bounce-back in its kernel and
recomputes boundary planes and Dirichlet plates with its dense pass on
slabs, whose relaxation divides by tau_g and whose velocity divides by
rho; the port's kernel computes every cell one way (multiplying by 1/tau_g
and 1/rho). So the two agree to rounding, at the tolerances lbm_tpu's own
tests hold its two routes to: frozen atol 2e-6 to 5e-5, coupled rtol 2e-5
of the field's scale (f rtol 2e-5), thermal rtol 1e-4 / atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.cases import thermal as ref_cases
from lbm_tpu.core.units import UnitSystem as RefUnits
from lbm_tpu.engine.spec import CaseSpec as RefCaseSpec
from lbm_tpu.kernels.scalar_stream import (
    BuoyantTransportPallas,
    CoupledTransportPallas,
    ScalarTransportPallas,
)
from lbm_tpu_torch import bridge
from lbm_tpu_torch.cases import thermal as cases
from lbm_tpu_torch.engine.scalar import CoupledTransport, ScalarTransport
from lbm_tpu_torch.engine.thermal import BuoyantTransport
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.kernels import scalar_stream as S


def _closed_box(n):
    mask = np.full((n, n, n), int(CellType.WALL), np.int32)
    mask[1:-1, 1:-1, 1:-1] = int(CellType.FLUID)
    return RefCaseSpec(name="box", shape=(n, n, n), tau=0.6,
                       units=RefUnits(CH=1e-4, C_U=1.0), mask=mask,
                       boundaries=[])


def _random_u(spec, seed, scale):
    rng = np.random.default_rng(seed)
    u = (scale * rng.standard_normal((3,) + tuple(spec.shape))).astype(
        np.float32)
    u[:, np.asarray(spec.mask) != CellType.FLUID] = 0.0
    return u


def _gates(gate):
    """The same bolus gate twice: traced for lbm_tpu, of the integer step
    for the port."""
    return ({0: lambda t: jnp.where(t < gate, 1.0, 0.0)},
            {0: lambda t: 1.0 if t < gate else 0.0})


FROZEN = {
    # label: (spec, u seed and scale, steps, options, record, c atol)
    "closed box": (lambda: _closed_box(12), (0, 0.04), 8,
                   dict(D=0.02, div_fix=False), None, 2e-6),
    "poiseuille wash-in div_fix": (
        lambda: ref_get_case("poiseuille", n=16), (1, 0.02), 30,
        dict(D=0.02, inlet_c={0: 1.0}), [0, 1], 5e-6),
    "coronary mean age": (
        lambda: ref_get_case("coronary", shape=(24, 20, 32), radius=4),
        (2, 0.02), 25, dict(D=0.02, inlet_c={0: 0.0}, source=1.0),
        [1, 2, 3, 4], 5e-5),
}


@pytest.mark.parametrize("label", sorted(FROZEN))
def test_frozen_plain_version_matches_pallas(label):
    """K7's plain version against ScalarTransportPallas(interpret=True) on
    a seeded velocity field: field, total and record series."""
    make, (seed, scale), steps, kw, record, atol = FROZEN[label]
    rspec = make()
    spec = bridge.case_from_reference(rspec)
    u = _random_u(spec, seed, scale)
    c0 = None
    if not rspec.boundaries:
        rng = np.random.default_rng(9)
        c0 = rng.random(spec.shape).astype(np.float32)
    ref = ScalarTransportPallas(rspec, u, c0=c0, interpret=True, **kw)
    port = ScalarTransport(spec, u, c0=c0, device="cpu", **kw)
    assert S.instance(port.sc, False) == (
        "frozen+comp" if kw.get("div_fix", True) else "frozen")
    sr = ref.run(steps, record=record)
    sp = port.run(steps, record=record)
    if record is not None:
        np.testing.assert_allclose(sp, sr, atol=atol)
    np.testing.assert_allclose(port.concentration().numpy(),
                               np.asarray(ref.concentration()), atol=atol)
    np.testing.assert_allclose(port.total(), ref.total(), rtol=1e-5,
                               atol=1e-6)
    assert float(port.concentration().abs().max()) > 0.1


def test_coupled_plain_version_matches_pallas_and_crosses_the_bridge():
    """K8 behind the flow kernel: the port's kernel route (plain versions)
    against CoupledTransportPallas(interpret=True) on a small pulsatile
    coronary with a bolus, 12 steps; then the packed g and f are carried
    across the bridge into a second port transport and both packages step
    12 more."""
    kw = dict(shape=(24, 20, 32), radius=4, pulsatile=(4, 8))
    rspec = ref_get_case("coronary", **kw)
    spec = bridge.case_from_reference(rspec)
    rgate, gate = _gates(8)
    rec = [0, 1, 2, 3, 4]
    ref = CoupledTransportPallas(rspec, D=0.02, inlet_c=rgate,
                                 interpret=True)
    port = CoupledTransport(spec, D=0.02, inlet_c=gate, device="cpu")

    def check(port, sp, sr):
        scale = float(np.abs(np.asarray(ref.concentration())).max())
        assert scale > 0.1
        np.testing.assert_allclose(sp, sr, rtol=2e-5, atol=2e-5 * scale)
        np.testing.assert_allclose(port.concentration().numpy(),
                                   np.asarray(ref.concentration()),
                                   rtol=2e-5, atol=2e-5 * scale)
        f_ref = bridge.unpack_lattice(ref.p, spec.shape, 19)
        np.testing.assert_allclose(port.f.numpy(), f_ref, rtol=2e-5,
                                   atol=1e-7)

    sr = ref.run(12, record=rec)
    check(port, port.run(12, record=rec), sr)
    state = bridge.transport_state_from_reference(ref)
    assert state["g"].shape == (7,) + spec.shape and state["t"] == 12
    carried = CoupledTransport(
        spec, inlet_c=gate, device="cpu",
        **bridge.transport_kwargs_from_reference(ref))
    bridge.load_transport_state(carried, state)
    sr = ref.run(12, record=rec)
    check(carried, carried.run(12, record=rec), sr)
    assert carried.t == 24


THERMAL = {
    "cavity3d": ("heated_cavity_3d", dict(n=12, ra=1e3), 24),
    "rb3d": ("rayleigh_benard_3d",
             dict(nx=16, ny=10, nz=10, ra=4000.0, perturb=1e-2), 40),
}


@pytest.mark.parametrize("label", sorted(THERMAL))
def test_thermal_plain_versions_match_pallas(label):
    """K1e + K8 with Dirichlet plates: the port's kernel route (plain
    versions) against BuoyantTransportPallas(interpret=True), the
    temperature at rtol 1e-4 / atol 1e-5 and the buoyant macro u at 3e-4
    of its scale; on the cavity the packed state then crosses the bridge
    and both packages step as many steps again."""
    name, args, steps = THERMAL[label]
    rspec, rkw, _ = getattr(ref_cases, name)(**args)
    spec, kw, _ = getattr(cases, name)(**args)
    ref = BuoyantTransportPallas(rspec, interpret=True, **rkw)
    port = BuoyantTransport(spec, device="cpu", **kw)

    def check(port):
        np.testing.assert_allclose(port.concentration().numpy(),
                                   np.asarray(ref.concentration()),
                                   rtol=1e-4, atol=1e-5)
        u, ru = port.macro()[1].numpy(), np.asarray(ref.macro()[1])
        fluid = port.fluid.numpy()
        scale = np.abs(ru).max()
        assert scale > 1e-6
        np.testing.assert_allclose(u[:, fluid], ru[:, fluid],
                                   atol=3e-4 * scale)

    ref.run(steps)
    port.run(steps)
    check(port)
    if label != "cavity3d":
        return
    carried = BuoyantTransport(
        spec, device="cpu",
        **bridge.transport_kwargs_from_reference(ref, wall_c=rkw["wall_c"]))
    assert tuple(carried.buoyancy) == tuple(port.buoyancy)
    bridge.load_transport_state(carried,
                                bridge.transport_state_from_reference(ref))
    ref.run(steps)
    carried.run(steps)
    assert carried.t == 2 * steps
    check(carried)


def test_bridge_unpacks_the_packed_frozen_state():
    """ScalarTransportPallas keeps g packed (X + 2, Y + 2, 8, Z): carried
    into the port after 10 steps, 10 more in each package agree."""
    rspec = ref_get_case("coronary", shape=(24, 20, 32), radius=4)
    spec = bridge.case_from_reference(rspec)
    u = _random_u(spec, 4, 0.02)
    rgate, gate = _gates(14)
    ref = ScalarTransportPallas(rspec, u, D=0.02, inlet_c=rgate,
                                interpret=True)
    ref.run(10)
    assert np.asarray(ref.g).shape[2] == 8
    port = ScalarTransport(spec, inlet_c=gate, device="cpu",
                           **bridge.transport_kwargs_from_reference(ref, u=u))
    bridge.load_transport_state(port,
                                bridge.transport_state_from_reference(ref))
    sr = ref.run(10, record=[0])
    sp = port.run(10, record=[0])
    np.testing.assert_allclose(sp, sr, atol=2e-6)
    np.testing.assert_allclose(port.concentration().numpy(),
                               np.asarray(ref.concentration()), atol=5e-6)
    with pytest.raises(ValueError, match="does not hold"):
        bridge.unpack_lattice(np.zeros((4, 4, 8, 4)), spec.shape, 7)
