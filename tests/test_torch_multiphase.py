"""The Shan-Chen and binary-liquid ports (lbm_tpu_torch/engine/multiphase.py
and engine/binary.py) held against lbm_tpu on the CPU: the force and
chemical-potential pieces alone, the states after 20 steps, the bridge, and
lbm_tpu's own physics assertions on the port's longer runs (a phase-
separating quench amplifies last-bit differences, so those are not compared
field for field).

Tolerance: rtol 3e-6 / atol 1e-7 on f and g, but where the quantity goes
through exp (psi = 1 - exp(-rho): sc_force, the ShanChen states), where XLA
and torch round exp differently on the CPU: rtol 1e-5 there. u is a
difference of populations of order 0.05 divided by rho: atol 5e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core.units import UnitSystem
from lbm_tpu.engine import binary as ref_binary
from lbm_tpu.engine import multiphase as ref_mp
from lbm_tpu.engine.spec import CaseSpec as RefCaseSpec
from lbm_tpu.geometry.mask import CellType
from lbm_tpu_torch import bridge
from lbm_tpu_torch.engine import binary, multiphase
from lbm_tpu_torch.engine.binary import BinaryFluid
from lbm_tpu_torch.engine.multiphase import ShanChen, eos_pressure

_UNITS = UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0)


@pytest.fixture(autouse=True)
def _torch_one_thread():
    """The boxes are tiny: torch's intra-op threads would only contend with
    the other test workers' for the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(shape, tau=1.0):
    mask = np.full(shape, int(CellType.FLUID), np.int32)
    ref = RefCaseSpec(name="box", shape=shape, tau=tau, units=_UNITS,
                      mask=mask, boundaries=[])
    return ref, bridge.case_from_reference(ref)


def _noisy_rho(shape, rho0=np.log(2.0), amp=0.01, seed=0):
    rng = np.random.default_rng(seed)
    return (rho0 * (1.0 + amp * rng.standard_normal(shape))
            ).astype(np.float32)


def _close(got, want, rtol=3e-6, atol=1e-7):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("G", [-3.0, -5.0])
def test_sc_force_and_eos_match_lbm_tpu(G):
    """psi, the 18-roll interaction force and the EOS on a seeded density
    (rtol 1e-5: exp)."""
    rho = _noisy_rho((10, 8, 6), amp=0.3, seed=1)
    t = torch.from_numpy(rho)
    _close(multiphase.psi_of(t), ref_mp.psi_of(jnp.asarray(rho)), 1e-5)
    _close(multiphase.sc_force(t, G), ref_mp.sc_force(jnp.asarray(rho), G),
           1e-5, 1e-8)
    _close(eos_pressure(t, G), ref_mp.eos_pressure(jnp.asarray(rho), G),
           1e-5)
    # pairwise antisymmetric: the box total is zero
    tot = multiphase.sc_force(t, G).sum(dim=(1, 2, 3), dtype=torch.float64)
    assert float(tot.abs().max()) < 1e-6


@pytest.mark.parametrize("G,shape", [(-3.0, (12, 6, 4)), (-5.0, (10, 8, 6))])
def test_shan_chen_steps_match_lbm_tpu(G, shape):
    """20 steps from a seeded density: f (rtol 1e-5: exp), rho, u and the
    total mass."""
    rspec, spec = _boxes(shape)
    rho0 = _noisy_rho(shape, seed=2)
    ref = ref_mp.ShanChen(rspec, G=G, rho_init=rho0)
    sc = ShanChen(spec, G=G, rho_init=rho0, device="cpu")
    _close(sc.f, ref.f)
    ref.run(20)
    sc.run(20)
    assert sc.t == ref.t == 20
    _close(sc.f, ref.f, 1e-5)
    rho, u = sc.macro()
    rrho, ru = ref.macro()
    _close(rho, rrho, 1e-5)
    _close(u, ru, 0, 5e-7)
    _close(sc.pressure(), ref.pressure(), 1e-5)
    assert sc.total_mass() == pytest.approx(ref.total_mass(), rel=1e-6)


def test_shan_chen_bridge_round_trip():
    """A lbm_tpu ShanChen's (f, t) loaded into the port (and the port's
    back into lbm_tpu) continue as the other package's run (rtol 1e-5)."""
    shape = (10, 6, 4)
    rspec, spec = _boxes(shape)
    ref = ref_mp.ShanChen(rspec, G=-5.0, rho_init=_noisy_rho(shape, seed=4))
    ref.run(5)
    sc = ShanChen(spec, G=-5.0, device="cpu")
    bridge.load_lattice_state(sc, bridge.lattice_state_from_reference(ref))
    assert sc.t == 5 and bridge.lattice_state_from_reference(ref)["g"] is None
    ref.run(5)
    sc.run(5)
    _close(sc.f, ref.f, 1e-5)
    back = bridge.lattice_state_to_numpy(sc)
    ref.f, ref.t = jnp.asarray(back["f"]), back["t"]
    ref.run(3)
    sc.run(3)
    _close(sc.f, ref.f, 1e-5)


def test_shan_chen_refuses_a_case_force():
    spec = bridge.case_from_reference(_boxes((4, 4, 4))[0])
    spec.force = (1e-5, 0.0, 0.0)
    with pytest.raises(ValueError, match="replaces CaseSpec.force"):
        ShanChen(spec, G=-5.0, device="cpu")
    with pytest.raises(ValueError, match="replaces CaseSpec.force"):
        BinaryFluid(spec, device="cpu")


def test_binary_pieces_match_lbm_tpu():
    """grad_c, lap_c, the chemical potential (phi^3 as XLA's multiplies),
    the CH equilibrium, on seeded fields."""
    rng = np.random.default_rng(7)
    phi = np.tanh(rng.standard_normal((10, 8, 6))).astype(np.float32)
    u = (0.05 * rng.standard_normal((3, 10, 8, 6))).astype(np.float32)
    t, jt = torch.from_numpy(phi), jnp.asarray(phi)
    _close(binary.grad_c(t), ref_binary.grad_c(jt))
    _close(binary.lap_c(t), ref_binary.lap_c(jt))
    mu = binary.chemical_potential(t, 0.04, 0.08)
    rmu = ref_binary.chemical_potential(jt, 0.04, 0.08)
    _close(mu, rmu)
    _close(binary._g_eq(t, mu, torch.from_numpy(u), 0.3),
           ref_binary._g_eq(jt, rmu, jnp.asarray(u), 0.3))
    assert binary.interface_width(0.02, 0.08) == ref_binary.interface_width(
        0.02, 0.08)
    assert binary.surface_tension(0.02, 0.08) == ref_binary.surface_tension(
        0.02, 0.08)


@pytest.mark.parametrize("A,kappa,gamma,tau_g", [
    (0.04, 0.04, 0.3, 0.8), (0.002, 0.008, 0.5, 0.8)])
def test_binary_fluid_steps_match_lbm_tpu(A, kappa, gamma, tau_g):
    """20 steps from a seeded order parameter: f, g, phi, rho."""
    shape = (12, 8, 6)
    rspec, spec = _boxes(shape, tau=0.8)
    rng = np.random.default_rng(11)
    x = np.arange(shape[0])[:, None, None]
    phi0 = (np.where((x > 3) & (x < 9), 0.5, -0.5)
            + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    kw = dict(A=A, kappa=kappa, gamma=gamma, tau_g=tau_g, phi_init=phi0)
    ref = ref_binary.BinaryFluid(rspec, **kw)
    bf = BinaryFluid(spec, device="cpu", **kw)
    _close(bf.g, ref.g)
    ref.run(20)
    bf.run(20)
    assert np.isfinite(bf.g.numpy()).all()
    _close(bf.f, ref.f)
    _close(bf.g, ref.g)
    _close(bf.phi(), ref.phi())
    _close(bf.rho(), ref.rho())
    assert bf.total_phi() == pytest.approx(ref.total_phi(), abs=1e-4)
    state = bridge.lattice_state_from_reference(ref)
    bf2 = BinaryFluid(spec, device="cpu", **kw)
    bridge.load_lattice_state(bf2, state)
    ref.run(3)
    bf2.run(3)
    assert bf2.t == ref.t
    _close(bf2.g, ref.g)


def test_subcritical_stays_uniform_supercritical_separates():
    """lbm_tpu's spinode anchor on the port: at rho ~ ln 2 the uniform
    state is stable for G > -4 and separates below it
    (tests/test_multiphase.py)."""
    shape = (24, 4, 4)
    rho0 = _noisy_rho(shape)
    sub = ShanChen(_boxes(shape)[1], G=-3.0, rho_init=rho0, device="cpu")
    sup = ShanChen(_boxes(shape)[1], G=-5.0, rho_init=rho0, device="cpu")
    for s in (sub, sup):
        s.run(1500)
    assert float(np.ptp(sub.rho().numpy())) < 0.05
    assert float(np.ptp(sup.rho().numpy())) > 0.5
    assert np.isfinite(sup.rho().numpy()).all()


def test_momentum_conserved_in_periodic_box():
    """lbm_tpu's momentum anchor on the port: total momentum stays at
    rounding scale through phase separation."""
    shape = (16, 16, 4)
    sc = ShanChen(_boxes(shape)[1], G=-5.0,
                  rho_init=_noisy_rho(shape, seed=3), device="cpu")
    sc.run(800)
    rho, u = sc.macro()
    mom = (rho[None] * u).numpy().sum(axis=(1, 2, 3))
    assert np.abs(mom).max() < 1e-3, mom


def test_planar_interface_is_tanh_with_analytic_width():
    """lbm_tpu's planar-interface anchor on the port: the slab relaxes to
    and holds tanh with width within 10% of sqrt(2 kappa/A), phi
    conserved, bulks at the Landau minima."""
    A, K = 0.02, 0.08
    n = 64
    shape = (n, 4, 4)
    xi = binary.interface_width(A, K)
    x = np.arange(n, dtype=np.float64)
    phi0 = (np.tanh((x - 16) / xi) - np.tanh((x - 48) / xi) - 1.0)
    phi0 = np.broadcast_to(phi0[:, None, None].astype(np.float32),
                           shape).copy()
    bf = BinaryFluid(_boxes(shape, tau=0.8)[1], A=A, kappa=K, phi_init=phi0,
                     device="cpu")
    tot0 = bf.total_phi()
    bf.run(2000)
    phi = bf.phi().numpy()[:, 2, 2]
    assert np.isfinite(phi).all()
    assert bf.total_phi() == pytest.approx(tot0, abs=1e-3 * n * 16)
    sel = (x > 8) & (x < 24)
    slope, _ = np.polyfit(x[sel], np.arctanh(np.clip(phi[sel], -0.999,
                                                     0.999)), 1)
    assert 1.0 / slope == pytest.approx(xi, rel=0.10)
    assert abs(phi[32] - 1.0) < 0.02 and abs(phi[2] + 1.0) < 0.05
