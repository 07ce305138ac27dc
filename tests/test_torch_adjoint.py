"""The adjoint port (lbm_tpu_torch/engine/adjoint.py, with step.py's and
scalar.py's traced parameters) held against lbm_tpu on the CPU.

- make_step_theta at the static RCR values is make_step_wk bit for bit;
- rollout is bit for bit the same across remat_chunk, and the static
  step's run;
- d P_c / d log Rd through a 60-step rollout against lbm_tpu's jax.grad
  (rtol 1e-3) and central finite differences (rtol 2e-2, h = 0.1);
- the same three for transport_rollout and d loss / d log(tau_g - 1/2);
- Adam against optax.adam on a fixed gradient sequence (rtol 1e-6);
- two fit_windkessel iterations against lbm_tpu's history, and two
  fit_diffusivity iterations (tolerances in each test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine import adjoint as ref_adj
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.engine.scalar import ScalarTransport as RefScalarTransport
from lbm_tpu_torch import bridge
from lbm_tpu_torch.engine import adjoint
from lbm_tpu_torch.engine.compile import compile_case, wk_init
from lbm_tpu_torch.engine.scalar import ScalarTransport
from lbm_tpu_torch.engine.step import (
    initial_f,
    make_step_wk,
    windkessel_update,
)

_WK = (5e-4, 24000.0, 2.5e-3)  # Rp, C, Rd (lattice)


@pytest.fixture(autouse=True)
def _torch_one_thread():
    """The boxes are tiny: torch's intra-op threads would only contend with
    the other test workers' for the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases(name="poiseuille", **kw):
    ref = ref_get_case(name, **kw)
    return ref, bridge.case_from_reference(ref)


def test_step_theta_is_the_static_step_bit_for_bit():
    """theta == the compiled-in RCR values: 30 steps of make_step_theta
    equal make_step_wk's f and P_c bit for bit (the traced route's tensor
    arithmetic is the static route's fp32 constants')."""
    cc = compile_case(_cases(n=16, windkessel=_WK)[1])
    theta = bridge.theta_from_numpy(adjoint.wk_params(cc))
    step_s, step_t = make_step_wk(cc), adjoint.make_step_theta(cc)
    f_s = f_t = initial_f(cc)
    wk_s = wk_t = torch.from_numpy(wk_init(cc.bcs))
    for t in range(30):
        f_s, _, _, wk_s = step_s(f_s, t, wk_s)
        f_t, wk_t = step_t(f_t, t, wk_t, theta)
    assert torch.equal(f_t, f_s) and torch.equal(wk_t, wk_s)
    assert float(wk_t[0]) != 0.0
    with pytest.raises(ValueError, match="needs windkessel outlets"):
        adjoint.make_step_theta(compile_case(_cases(n=8)[1]))


def test_rollout_is_chunking_invariant_and_the_static_run():
    """remat_chunk 10 and 30 give the same state bit for bit, the static
    step's 60 steps too, and lbm_tpu's rollout at rtol 3e-6; a chunk that
    does not divide the horizon is refused."""
    rspec, spec = _cases(n=12, windkessel=_WK)
    cc = compile_case(spec)
    theta = bridge.theta_from_numpy(adjoint.wk_params(cc))
    f_a, wk_a = adjoint.rollout(cc, theta, 60, remat_chunk=10)
    f_b, wk_b = adjoint.rollout(cc, theta, 60, remat_chunk=30)
    assert torch.equal(f_a, f_b) and torch.equal(wk_a, wk_b)
    step = make_step_wk(cc)
    f, wk = initial_f(cc), torch.from_numpy(wk_init(cc.bcs))
    for t in range(60):
        f, _, _, wk = step(f, t, wk)
    assert torch.equal(f_a, f) and torch.equal(wk_a, wk)
    rcc = ref_compile_case(rspec)
    np.testing.assert_array_equal(bridge.theta_to_numpy(theta),
                                  ref_adj.wk_params(rcc))
    rf, rwk = ref_adj.rollout(rcc, jnp.asarray(bridge.theta_to_numpy(theta)),
                              60, remat_chunk=20)
    np.testing.assert_allclose(f_a.numpy(), np.asarray(rf), rtol=3e-6,
                               atol=1e-7)
    np.testing.assert_allclose(wk_a.numpy(), np.asarray(rwk), rtol=3e-6)
    with pytest.raises(ValueError, match="must divide"):
        adjoint.rollout(cc, theta, 60, remat_chunk=25)


def test_adjoint_gradient_matches_jax_grad_and_fd():
    """d P_c(final) / d log Rd through a 60-step rollout: within rtol 1e-3
    of lbm_tpu's jax.grad of the same loss, and 2e-2 of central finite
    differences (h = 0.1, as lbm_tpu's test)."""
    rspec, spec = _cases(n=12, windkessel=_WK)
    cc = compile_case(spec)
    base = bridge.theta_from_numpy(adjoint.wk_params(cc))

    def loss(log_rd):
        theta = torch.cat([base[:, :2], torch.exp(log_rd).reshape(1, 1)], 1)
        return adjoint.rollout(cc, theta, 60, remat_chunk=20)[1][0]

    x0 = torch.log(base[0, 2]).requires_grad_(True)
    (auto,) = torch.autograd.grad(loss(x0), x0)
    auto = float(auto)
    with torch.no_grad():
        fd = (float(loss(x0 + 0.1)) - float(loss(x0 - 0.1))) / 0.2
    rcc = ref_compile_case(rspec)
    rbase = jnp.asarray(ref_adj.wk_params(rcc))

    def rloss(log_rd):
        theta = rbase.at[0, 2].set(jnp.exp(log_rd))
        return ref_adj.rollout(rcc, theta, 60, remat_chunk=20)[1][0]

    ref = float(jax.jit(jax.grad(rloss))(jnp.log(rbase[0, 2])))
    assert auto != 0.0
    np.testing.assert_allclose(auto, ref, rtol=1e-3)
    np.testing.assert_allclose(auto, fd, rtol=2e-2)


def test_outlet_fluxes_match_the_coupling_and_lbm_tpu():
    """outlet_fluxes reads what the RCR ODE integrates: one more update
    driven by its q reproduces the carried P_c'; and it is lbm_tpu's
    outlet_fluxes on the same state (rtol 1e-5: a sum over the plane in
    another order), flow_split too."""
    rspec, spec = _cases(n=12, windkessel=_WK)
    cc = compile_case(spec)
    theta = bridge.theta_from_numpy(adjoint.wk_params(cc))
    f, wk = adjoint.rollout(cc, theta, 40, remat_chunk=20)
    q = adjoint.outlet_fluxes(cc, f)
    _, wk_next = adjoint.make_step_theta(cc)(f, 40, wk, theta)
    p_pred, _ = windkessel_update(wk[0], q[0], _WK)
    np.testing.assert_allclose(float(wk_next[0]), float(p_pred), rtol=1e-6)
    rcc = ref_compile_case(rspec)
    np.testing.assert_allclose(
        q.numpy(), np.asarray(ref_adj.outlet_fluxes(rcc, jnp.asarray(
            f.numpy()))), rtol=1e-5)
    np.testing.assert_allclose(
        adjoint.flow_split(cc, f).numpy(),
        np.asarray(ref_adj.flow_split(rcc, jnp.asarray(f.numpy()))),
        rtol=1e-6)


def test_adam_matches_optax():
    """Adam's updates and iterates on a fixed sequence of gradients
    (signs, scales and zeros mixed) against optax.adam at rtol 1e-6."""
    rng = np.random.default_rng(0)
    grads = (rng.standard_normal((25, 4)) * np.logspace(-6, 1, 4)
             ).astype(np.float32)
    grads[3] = 0.0
    for lr in (0.3, 0.05):
        opt, ropt = adjoint.Adam(lr), optax.adam(lr)
        x, rx = torch.zeros(4), jnp.zeros(4, jnp.float32)
        state, rstate = opt.init(x), ropt.init(rx)
        for g in grads:
            upd, state = opt.update(torch.from_numpy(g), state)
            rupd, rstate = ropt.update(jnp.asarray(g), rstate)
            x, rx = x + upd, optax.apply_updates(rx, rupd)
            np.testing.assert_allclose(upd.numpy(), np.asarray(rupd),
                                       rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=1e-6,
                                       atol=1e-12)


def test_fit_windkessel_two_iterations_match_lbm_tpu():
    """Two fit_windkessel iterations on the small four-outlet coronary
    (poiseuille has one outlet, whose split is 1 whatever Rd): each
    iterate's loss and split and the best theta against lbm_tpu's, at rtol
    1e-4 (the flow's 40 steps of last-bit differences, exp, and two
    gradient steps apart)."""
    wk = [(1e-4, 5e3, 2e-3)] * 4
    kw = dict(shape=(48, 24, 40), radius=5, windkessel=wk)
    rspec, spec = _cases("coronary", **kw)
    target = np.asarray([0.40, 0.30, 0.18, 0.12], np.float32)
    fit = dict(n_steps=100, iters=2, lr=0.35, remat_chunk=50)
    theta, hist = adjoint.fit_windkessel(spec, target, device="cpu", **fit)
    rtheta, rhist = ref_adj.fit_windkessel(rspec, target, **fit)
    assert len(hist) == len(rhist) == 2
    for (loss, split), (rloss, rsplit) in zip(hist, rhist):
        np.testing.assert_allclose(loss, rloss, rtol=1e-4)
        np.testing.assert_allclose(split, np.asarray(rsplit), rtol=1e-4)
    np.testing.assert_allclose(theta, rtheta, rtol=1e-4)
    assert hist[1][0] < hist[0][0]


def _frozen(n=14, D=0.03):
    """A frozen poiseuille field from lbm_tpu's xla Simulation (300 steps)
    and both packages' dense transports on it."""
    rspec, spec = _cases(n=n)
    sim = RefSimulation(rspec, backend="xla")
    sim.run(max_steps=300, time_save=100, verbose=False)
    u = np.asarray(sim.macro()[1])
    ref = RefScalarTransport(rspec, u, D=D, inlet_c={0: 1.0})
    st = ScalarTransport(spec, u, D=D, inlet_c={0: 1.0}, device="cpu",
                         backend="dense")
    return ref, st


@pytest.fixture(scope="module")
def frozen():
    return _frozen()


def test_transport_rollout_is_run_and_chunking_invariant(frozen):
    """transport_rollout at the instance's own tau_g (a number) is the
    dense run's record bit for bit, across remat chunks; at a tensor tau_g
    within rtol 2e-6 (1/tau_g rounded from fp32 instead of float64); and
    lbm_tpu's transport_rollout at rtol 1e-5 (lbm_tpu divides by tau_g,
    the port multiplies by 1/tau_g: the kernel's form)."""
    ref, st = frozen
    a = adjoint.transport_rollout(st, st.tau_g, 50, [1], remat_chunk=25)
    b = adjoint.transport_rollout(st, st.tau_g, 50, [1], remat_chunk=10)
    assert torch.equal(a, b) and st.t == 0
    st2 = ScalarTransport(st.spec, st.sc.u, tau_g=st.tau_g,
                          inlet_c={0: 1.0}, device="cpu", backend="dense")
    np.testing.assert_array_equal(a.numpy(), st2.run(50, record=[1]))
    c = adjoint.transport_rollout(st, torch.tensor(st.tau_g), 50, [1],
                                  remat_chunk=25)
    np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=2e-6, atol=1e-9)
    r = ref_adj.transport_rollout(ref, ref.tau_g, 50, [1], remat_chunk=25)
    np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                               atol=1e-7)


def test_diffusivity_gradient_matches_jax_grad_and_fd(frozen):
    """d mean((series - obs)^2) / d log(tau_g - 1/2) through a 40-step
    transport rollout: rtol 1e-3 of lbm_tpu's jax.grad, 2e-2 of central
    differences (eps = 1e-2, as lbm_tpu's test)."""
    ref, st = frozen
    obs = adjoint.transport_rollout(st, 0.5 + 4 * 0.05, 40, [1],
                                    remat_chunk=20)

    def loss(x):
        s = adjoint.transport_rollout(st, 0.5 + torch.exp(x), 40, [1],
                                      remat_chunk=20)
        return torch.mean((s - obs) ** 2)

    x0 = torch.log(torch.tensor(4 * 0.03, dtype=torch.float32))
    x = x0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x), x)
    g = float(g)
    with torch.no_grad():
        fd = (float(loss(x0 + 1e-2)) - float(loss(x0 - 1e-2))) / 2e-2
    robs = jnp.asarray(ref_adj.transport_rollout(ref, 0.5 + 4 * 0.05, 40,
                                                 [1], remat_chunk=20))

    def rloss(x):
        s = ref_adj.transport_rollout(ref, 0.5 + jnp.exp(x), 40, [1],
                                      remat_chunk=20)
        return jnp.mean((s - robs) ** 2)

    rg = float(jax.grad(rloss)(jnp.log(jnp.float32(4 * 0.03))))
    assert g != 0.0
    np.testing.assert_allclose(g, rg, rtol=1e-3)
    np.testing.assert_allclose(g, fd, rtol=2e-2)


def test_fit_diffusivity_two_iterations_match_lbm_tpu(frozen):
    """Two fit_diffusivity iterations from D0 = 0.1 toward a series made
    at D = 0.04: the losses (rtol 1e-3) and D iterates (rtol 1e-5) of
    lbm_tpu's fit, and the loss falls."""
    ref, st = frozen
    obs = adjoint.transport_rollout(st, 0.5 + 4 * 0.04, 50, [1],
                                    remat_chunk=25).numpy()
    d, hist = adjoint.fit_diffusivity(st, obs, [1], iters=2, lr=0.15, D0=0.1,
                                      remat_chunk=25)
    rd, rhist = ref_adj.fit_diffusivity(ref, obs.astype(np.float32), [1],
                                        iters=2, lr=0.15, D0=0.1,
                                        remat_chunk=25)
    for (loss, d_it), (rloss, rd_it) in zip(hist, rhist):
        np.testing.assert_allclose(loss, rloss, rtol=1e-3)
        np.testing.assert_allclose(d_it, rd_it, rtol=1e-5)
    np.testing.assert_allclose(d, rd, rtol=1e-5)
    assert hist[1][0] < hist[0][0]
