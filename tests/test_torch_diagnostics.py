"""The port's plane diagnostics (engine/diagnostics.py) against
lbm_tpu's on seeded fields: plane_flux, plane_pressure and ffr equal
exactly, from NumPy arrays and from torch tensors; and on a windkessel
run, the flux through each outlet against the carried state's inputs."""

import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine import diagnostics as ref_diag
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine import diagnostics as diag
from lbm_tpu_torch.engine.runner import Simulation

WK4 = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3), (1e-4, 5e3, 4e-3),
       (1e-4, 5e3, 8e-3)]
CASES = [
    ("coronary", dict(shape=(48, 24, 40), radius=5, windkessel=WK4)),
    ("coronary", dict(shape=(24, 20, 32), radius=4)),
    ("poiseuille", dict(n=16, windkessel=(5e-4, 24000.0, 2.5e-3))),
    ("curved_vessel", dict(n=24, nphase=4, period_steps=8)),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the boxes here are small, and a thread pool
    spends its time waiting for its threads when the suite runs files in
    parallel workers, which made this file many times slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    rho = (1.0 + rng.normal(0, 1e-3, shape)).astype(np.float32)
    u = rng.normal(0, 1e-2, (3,) + tuple(shape)).astype(np.float32)
    return rho, u


@pytest.mark.parametrize("name,kw", CASES)
def test_plane_diagnostics_equal_lbm_tpus(name, kw):
    spec = get_case(name, **kw)
    ref = ref_get_case(name, **kw)
    rho, u = _fields(spec.shape, 11)
    for k in range(len(spec.boundaries)):
        want = ref_diag.plane_flux(ref, u, k)
        assert diag.plane_flux(spec, u, k) == want
        assert diag.plane_flux(spec, torch.from_numpy(u), k) == want
        want = ref_diag.plane_pressure(ref, rho, k)
        assert diag.plane_pressure(spec, rho, k) == want
        assert diag.plane_pressure(spec, torch.from_numpy(rho), k) == want
        assert diag.plane_pressure(spec, rho, k, gauge=0.99) == \
            ref_diag.plane_pressure(ref, rho, k, gauge=0.99)
    n = len(spec.boundaries)
    for a, b in [(0, n - 1), (0, 1)]:
        for p_a in (90.0, 100.0):
            assert diag.ffr(spec, torch.from_numpy(rho), a, b, p_a) == \
                ref_diag.ffr(ref, rho, a, b, p_a)
    assert diag.MMHG_PER_PA == ref_diag.MMHG_PER_PA


def test_outlet_flux_of_a_windkessel_run():
    """plane_flux of a macro() field on each RCR outlet (the outward flux
    the windkessel coupling integrates) and ffr between the inlet and the
    main outlet of a short kernel-route run are finite, and the main
    outlet's flux is nonzero."""
    spec = get_case("coronary", **CASES[0][1])
    sim = Simulation(spec, device="cpu")
    sim.run(max_steps=40, time_save=40, verbose=False)
    rho, u = sim.macro()
    q = [diag.plane_flux(spec, u, k) for k in range(1, 5)]
    assert all(np.isfinite(q))
    assert q[0] != 0.0
    f, dp = diag.ffr(spec, rho, 0, 1)
    assert np.isfinite(f) and np.isfinite(dp)
