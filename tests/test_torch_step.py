"""The dense PyTorch step (the CPU twin) held against lbm_tpu's dense step
and against the lid16 golden field of the reference's numerics."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine import step as ref_step
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine import step

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_lid16_100.npz")


def _both(name, n=16):
    return (compile_case(get_case(name, n=n)),
            ref_compile_case(ref_get_case(name, n=n)))


@pytest.mark.parametrize("name", ["lid_driven_cavity", "poiseuille"])
def test_initial_f_bit_equal(name):
    cc, ref = _both(name)
    np.testing.assert_array_equal(step.initial_f(cc).numpy(),
                                  np.asarray(ref_step.initial_f(ref)))


@pytest.mark.parametrize("name", ["lid_driven_cavity", "poiseuille"])
def test_dense_step_matches_reference(name):
    """f after 4 steps at lbm_tpu's cross-backend tolerance."""
    cc, ref = _both(name)
    f = step.initial_f(cc)
    rf = ref_step.initial_f(ref)
    st, rst = step.make_step(cc), jax.jit(ref_step.make_step(ref))
    for t in range(4):
        f, rho, u = st(f, t)
        rf, rrho, ru = rst(rf, jnp.int32(t))
    np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=3e-6, atol=1e-7)
    fluid = np.asarray(ref.fluid)
    # u = m / rho of near-cancelling sums: absolute tolerance in units of
    # the lid speed (~0.06), as in tests/test_regression.py
    np.testing.assert_allclose(u.numpy()[:, fluid], np.asarray(ru)[:, fluid],
                               rtol=2e-4, atol=1.5e-6)
    np.testing.assert_allclose(
        step.fluid_speed_sum(cc, u).item(),
        float(np.sum(np.sqrt(np.sum(np.asarray(ru) ** 2, axis=0))[fluid])),
        rtol=1e-6)


def test_macro_fields_match_reference():
    cc, ref = _both("poiseuille")
    f = step.initial_f(cc)
    for t in range(3):
        f, _, _ = step.make_step(cc)(f, t)
    rho, u = step.macro_fields(cc, f)
    rrho, ru = ref_step.macro_fields(ref, jnp.asarray(f.numpy()))
    np.testing.assert_allclose(rho.numpy(), np.asarray(rrho), rtol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(ru), rtol=1e-6,
                               atol=1e-7)
    # non-fluid cells hold their init values exactly
    nonfluid = ~cc.fluid
    assert torch.equal(rho[nonfluid], cc.rho0[nonfluid])
    assert torch.equal(u[:, nonfluid], cc.u0[:, nonfluid])


def test_non_fluid_cells_keep_their_state():
    cc, _ = _both("lid_driven_cavity")
    f0 = step.initial_f(cc)
    f, _, _ = step.make_step(cc)(f0, 0)
    nonfluid = ~cc.fluid
    assert torch.equal(f[:, nonfluid], f0[:, nonfluid])


def test_lid16_golden_field():
    """100 steps against the reference's transcribed numerics, at the
    tolerances of tests/test_regression.py."""
    cc, _ = _both("lid_driven_cavity")
    f = step.initial_f(cc)
    st = step.make_step(cc)
    for t in range(100):
        f, _, _ = st(f, t)
    rho, u = step.macro_fields(cc, f)
    with np.load(GOLDEN) as g:
        np.testing.assert_allclose(u.numpy(), g["u"], rtol=2e-4, atol=1.5e-6)
        np.testing.assert_allclose(rho.numpy(), g["rho"], rtol=1e-5)


def test_pull_wraps_every_axis_like_jnp_roll():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 5, 6)).astype(np.float32)
    for e in ([1, 0, 0], [-1, 1, 0], [0, -1, 1], [1, 1, -1]):
        np.testing.assert_array_equal(
            step.pull_one(torch.from_numpy(a), e).numpy(),
            np.asarray(ref_step.pull_one(jnp.asarray(a), e)))
