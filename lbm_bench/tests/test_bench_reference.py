"""The plain reference against the port's dense backend at tiny sizes, for
each cell's physics: the lid cavity, the pulsatile coronary tree and its
RCR windkessel outlets."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lbm_bench.harness import u0_noise
from lbm_bench.reference.geometry import build
from lbm_bench.reference.scalar import Coupled
from lbm_bench.reference.stepper import Stepper

WK = [[2e-4, 2e4, 1e-3]] + [[2e-4, 2e4, 3e-3]] * 3
CASES = {
    "lid": ("lid_driven_cavity", {"n": 10}),
    "vessel": ("coronary", {"shape": [40, 24, 48], "radius": 4,
                            "pulsatile": [4, 12]}),
    "clinical": ("coronary", {"shape": [40, 24, 48], "radius": 4,
                              "pulsatile": [4, 12], "windkessel": WK}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_follows_the_dense_step(name):
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation

    case, params = CASES[name]
    steps = 14
    spec = get_case(case, **params)
    noise = u0_noise(5, spec.shape, 1e-3, "cpu")
    spec.u0 = np.where(spec.mask == 4, spec.u0 + noise, spec.u0).astype(
        np.float32)
    geom = build(case, params)
    assert np.array_equal(geom.mask, spec.mask)
    sim = Simulation(spec, device="cpu", backend="dense")
    ref = Stepper(geom, noise, "cpu")
    assert ref.max_abs_diff(sim.f[:, :], range(geom.shape[0])) == 0.0
    res = sim.run(max_steps=steps, time_save=steps, verbose=False)
    series = ref.run(steps)
    assert ref.max_abs_diff(sim.f, range(geom.shape[0])) <= 1e-7
    if res.velsum_series is not None:
        np.testing.assert_allclose(res.velsum_series, series, rtol=1e-12)
    if geom.residual == "usq":
        assert ref.usq() == pytest.approx(sim._usq_value(), rel=1e-12)
    if sim.wk is not None:
        np.testing.assert_allclose(sim.wk.numpy(), ref.wk.numpy(),
                                   rtol=1e-5)


def test_reference_loads_a_state_and_follows_it():
    case, params = CASES["clinical"]
    geom = build(case, params)
    a = Stepper(geom, None, "cpu")
    a.run(5)
    f = torch.zeros((19,) + geom.shape)
    flat = f.view(19, -1)
    flat[:, a.fluid_ids] = a.f_fluid
    b = Stepper(geom, None, "cpu")
    b.load(f, a.t, a.wk)
    a.run(4)
    b.run(4)
    assert torch.equal(a.f_fluid, b.f_fluid)
    assert torch.equal(a.wk, b.wk)


def test_reference_scalar_follows_the_coupled_kernel_route():
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.scalar import CoupledTransport

    from lbm_bench.entries.coupled_transport_run import Bolus

    case, params = CASES["vessel"]
    bolus = {"boundary": 0, "period": 6, "on": 4, "phase": 1}
    spec = get_case(case, **params)
    geom = build(case, params)
    ct = CoupledTransport(spec, D=0.02, inlet_c={0: Bolus(**bolus)},
                          device="cpu", backend="kernel")
    ref = Coupled(Stepper(geom, None, "cpu"), 0.02, bolus)
    rec = ct.run(9, record=[0, 1, 2, 3, 4])
    rec_ref = ref.run(9)
    assert float(ct.g.abs().max()) > 0.01
    np.testing.assert_allclose(rec, rec_ref, rtol=1e-12, atol=1e-15)
    assert ref.flow.max_abs_diff(ct.f, range(geom.shape[0])) == 0.0
    assert ref.g_max_abs_diff(ct.g, range(geom.shape[0])) == 0.0
