"""lbm_tpu_torch's lattice, geometry and compiled tables held against
lbm_tpu on the same seeded inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.core import lattice as ref_lattice
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.geometry import shapes as ref_shapes
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.geometry import shapes


def _random_state(seed, shape=(6, 5, 4)):
    rng = np.random.default_rng(seed)
    rho = (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.05 * rng.standard_normal((3,) + shape)).astype(np.float32)
    f = (0.05 + 0.02 * rng.random((19,) + shape)).astype(np.float32)
    return rho, u, f


def test_constants_match():
    np.testing.assert_array_equal(lattice.D3Q19.E, ref_lattice.D3Q19.E)
    np.testing.assert_array_equal(lattice.D3Q19.W, ref_lattice.D3Q19.W)
    np.testing.assert_array_equal(lattice.D3Q19.OPP, ref_lattice.D3Q19.OPP)
    for axis in range(3):
        for sign in (-1, 1):
            np.testing.assert_array_equal(
                lattice.D3Q19.dirs_into(axis, sign),
                ref_lattice.D3Q19.dirs_into(axis, sign))


@pytest.mark.parametrize("dirs", [None, (4, 8, 10, 16, 18), (1, 7, 11)])
@pytest.mark.parametrize("seed", [0, 1])
def test_phi_feq_match(seed, dirs):
    rho, u, _ = _random_state(seed)
    got_phi = lattice.phi(torch.from_numpy(u), dirs).numpy()
    ref_phi = np.asarray(ref_lattice.phi(jnp.asarray(u), dirs))
    np.testing.assert_allclose(got_phi, ref_phi, rtol=1e-6)
    got = lattice.feq(torch.from_numpy(rho), torch.from_numpy(u), dirs)
    ref = ref_lattice.feq(jnp.asarray(rho), jnp.asarray(u), dirs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_moments_match(seed):
    _, _, f = _random_state(seed)
    rho, u = lattice.moments(torch.from_numpy(f))
    ref_rho, ref_u = ref_lattice.moments(jnp.asarray(f))
    np.testing.assert_allclose(rho.numpy(), np.asarray(ref_rho), rtol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(ref_u), rtol=1e-6,
                               atol=1e-7)


def test_moments_guard_zero_density():
    f = torch.zeros((19, 2, 1, 1))
    f[1, 1] = 0.5
    rho, u = lattice.moments(f)
    assert rho[0].item() == 0.0 and torch.all(u[:, 0] == 0)
    assert u[0, 1].item() == 1.0


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 18, 10), (7, 7, 7)])
def test_cavity_mask_bit_equal(shape):
    np.testing.assert_array_equal(shapes.cavity_mask(*shape),
                                  ref_shapes.cavity_mask(*shape))


@pytest.mark.parametrize("shape", [(16, 16, 16), (17, 12, 17), (32, 20, 32)])
def test_pipe_mask_bit_equal(shape):
    np.testing.assert_array_equal(shapes.pipe_mask(*shape),
                                  ref_shapes.pipe_mask(*shape))
    np.testing.assert_array_equal(
        shapes.pipe_parabola(shape[0], shape[2], 0.09),
        ref_shapes.pipe_parabola(shape[0], shape[2], 0.09))


@pytest.mark.parametrize("name", ["lid_driven_cavity", "poiseuille"])
def test_case_specs_match(name):
    spec, ref = get_case(name, n=16), ref_get_case(name, n=16)
    assert spec.shape == tuple(ref.shape) and spec.tau == ref.tau
    np.testing.assert_array_equal(spec.mask, ref.mask)
    np.testing.assert_array_equal(spec.u0, ref.u0)
    np.testing.assert_array_equal(spec.rho0, ref.rho0)
    assert spec.units.C_pre == ref.units.C_pre
    assert len(spec.boundaries) == len(ref.boundaries)
    for bc, rb in zip(spec.boundaries, ref.boundaries):
        assert (bc.mask_value, bc.axis, bc.coord, bc.normal, bc.rho_mode,
                bc.u_mode, bc.u_value) == (rb.mask_value, rb.axis, rb.coord,
                                           rb.normal, rb.rho_mode, rb.u_mode,
                                           rb.u_value)


@pytest.mark.parametrize("name", ["lid_driven_cavity", "poiseuille"])
def test_compiled_tables_bit_equal(name):
    cc = compile_case(get_case(name, n=16))
    ref = ref_compile_case(ref_get_case(name, n=16))
    np.testing.assert_array_equal(cc.nbr_wall.numpy(), np.asarray(ref.nbr_wall))
    np.testing.assert_array_equal(cc.fluid.numpy(), np.asarray(ref.fluid))
    np.testing.assert_array_equal(cc.rho0.numpy(), np.asarray(ref.rho0))
    np.testing.assert_array_equal(cc.u0.numpy(), np.asarray(ref.u0))
    np.testing.assert_array_equal(cc.mask.numpy(), ref.spec.mask)
    assert cc.mask.dtype == torch.int8
    assert cc.velsum_offset == ref.velsum_offset
    assert cc.usq_offset == ref.usq_offset
    assert len(cc.bcs) == len(ref.bcs)
    for bc, rb in zip(cc.bcs, ref.bcs):
        assert (bc.axis, bc.consumer_coord, bc.dirs, bc.rho_fixed, bc.u_mode,
                bc.omega) == (rb.axis, rb.consumer_coord, rb.dirs,
                              rb.rho_fixed, rb.u_mode, rb.omega)
        np.testing.assert_array_equal(bc.valid.numpy(), np.asarray(rb.valid))
        np.testing.assert_array_equal(bc.phi_star.numpy(),
                                      np.asarray(rb.phi_star))
