"""Public helpers of lbm_tpu that the port's modules carry too, held
against lbm_tpu on the CPU: the opt-in literal first step
(engine/step.make_first_step) against lbm_tpu's and, with the dense step
after it, against the NumPy transcription of the CUDA reference as
tests/test_reference_parity.py holds lbm_tpu's; core/rheology.tau_eff and
engine/step.les_tau_eff; cases/poiseuille.analytic_profile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.cases.poiseuille import analytic_profile as ref_profile
from lbm_tpu.core.rheology import normalize_closure as ref_closure
from lbm_tpu.core.rheology import tau_eff as ref_tau_eff
from lbm_tpu.engine import step as ref_step
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.cases.poiseuille import analytic_profile
from lbm_tpu_torch.core.rheology import normalize_closure, tau_eff
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.step import (
    initial_f,
    les_tau_eff,
    macro_fields,
    make_first_step,
    make_step,
)
from reference_oracle import oracle_from_spec
from test_reference_parity import rel_l2


@pytest.fixture(autouse=True)
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_first_step_matches_lbm_tpu():
    """Poiseuille n=20, whose rim wall cells carry the parabola: the
    literal first step equals lbm_tpu's at the cross-backend tolerance
    and differs from the fused step."""
    cc = compile_case(get_case("poiseuille", n=20))
    rcc = ref_compile_case(ref_get_case("poiseuille", n=20))
    f = initial_f(cc)
    got = make_first_step(cc)(f, 0)
    want = jax.jit(ref_step.make_first_step(rcc))(ref_step.initial_f(rcc),
                                                   jnp.int32(0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-6,
                                   atol=1e-7)
    assert not torch.equal(got[0], make_step(cc)(f, 0)[0])


@pytest.mark.parametrize("name,kw,ldc_mode", [
    ("lid_driven_cavity", dict(n=16), True),
    ("poiseuille", dict(n=20), False)])
def test_first_step_then_dense_steps_match_the_reference_oracle(name, kw,
                                                                ldc_mode):
    """make_first_step for step 0, make_step after it, 200 steps: rho and
    u within 1e-5 relative L2 of the reference's literal transcription."""
    spec = get_case(name, max_steps=200, **kw)
    cc = compile_case(spec)
    first, step = make_first_step(cc), make_step(cc)
    f = initial_f(cc)
    f0 = f.numpy().copy()
    for k in range(200):
        f, _, _ = (first if k == 0 else step)(f, k)
    rho, u = (a.numpy() for a in macro_fields(cc, f))
    fluid = cc.fluid.numpy()
    o = oracle_from_spec(spec, ldc_mode=ldc_mode, f0=f0).run(200)
    u_o = np.stack([o.ux, o.uy, o.uz])
    fl3 = np.broadcast_to(fluid, u_o.shape)
    assert rel_l2(u[fl3], u_o[fl3]) < 1e-5
    assert rel_l2(rho[fluid], o.rho[fluid]) < 1e-5


CLOSURES = [
    (0.15, None),
    (None, {"model": "power_law", "K": 0.02, "n": 0.7}),
    (None, {"model": "carreau", "nu0": 0.1, "nu_inf": 0.01, "lam": 100.0,
            "n": 0.4}),
    (None, {"model": "carreau_yasuda", "nu0": 0.1, "nu_inf": 0.01,
            "lam": 100.0, "n": 0.4, "a": 1.5}),
    (None, {"model": "casson", "nu_c": 0.02, "tau_y": 1e-5}),
]


@pytest.mark.parametrize("cs,rheology", CLOSURES,
                         ids=["smag", "plaw", "cy", "cy_a1.5", "casson"])
def test_tau_eff_matches_lbm_tpu(cs, rheology):
    """tau_eff from a random pre-collision f_neq and rho (some cells at
    rho = 0), against lbm_tpu's core/rheology.tau_eff; Smagorinsky also
    through les_tau_eff."""
    rng = np.random.default_rng(11)
    fneq = (1e-3 * rng.standard_normal((19, 6, 5, 4))).astype(np.float32)
    rho = (1 + 0.01 * rng.standard_normal((6, 5, 4))).astype(np.float32)
    rho[0, 0, :2] = 0.0
    closure = normalize_closure(cs, rheology)
    assert closure == ref_closure(cs, rheology)
    got = tau_eff(torch.from_numpy(fneq), torch.from_numpy(rho), 0.6, closure)
    want = np.asarray(ref_tau_eff(jnp.asarray(fneq), jnp.asarray(rho), 0.6,
                                  closure))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    if cs is not None:
        les = les_tau_eff(torch.from_numpy(fneq), torch.from_numpy(rho), 0.6,
                          cs)
        assert torch.equal(les, got)
        np.testing.assert_allclose(
            les.numpy(), np.asarray(ref_step.les_tau_eff(
                jnp.asarray(fneq), jnp.asarray(rho), 0.6, cs)),
            rtol=1e-6, atol=0)


def test_analytic_profile_matches_lbm_tpu():
    for n, kw in ((20, {}), (33, dict(u_max_phys=0.3, C_U=2.0))):
        got = analytic_profile(n, **kw)
        np.testing.assert_array_equal(got, ref_profile(n, **kw))
    assert got.shape == (33, 33) and np.isclose(got.max(), 0.15, rtol=0.02)
