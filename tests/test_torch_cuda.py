"""The CUDA kernels held against their plain versions on a CUDA card.

Marked `cuda`; each test skips without a card. The file imports neither
jax nor lbm_tpu, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import pytest
import torch

from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.core.rheology import carreau_blood
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.step import initial_f
from lbm_tpu_torch.kernels import collide_stream as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name,n", [("lid_driven_cavity", 32),
                                    ("poiseuille", 24)])
def test_collide_stream_kernel_matches_plain(device, name, n):
    cc = compile_case(get_case(name, n=n), device)
    f = initial_f(cc)
    fk, buf = f.clone(), torch.empty_like(f)
    vs_k = torch.zeros(4, dtype=torch.float64, device=device)
    vs_p = torch.zeros(4, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(4):
        K.collide_stream(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        f, vs_p[t] = K.collide_stream_plain(f, cc, t)
    torch.cuda.synchronize()
    assert K.launches["lbm_collide_stream[bgk]"] == 4
    torch.testing.assert_close(fk, f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)


def test_macro_kernel_matches_plain(device):
    cc = compile_case(get_case("poiseuille", n=24), device)
    f = initial_f(cc)
    f, _ = K.collide_stream_plain(f, cc, 0)
    rho, u = K.macro(f)
    rho_p, u_p = K.macro_plain(f)
    torch.testing.assert_close(rho, rho_p, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(u, u_p, rtol=1e-6, atol=1e-7)


def test_simulation_backends_agree_on_the_card(device):
    spec = get_case("lid_driven_cavity", n=24)
    a = Simulation(spec, device=device)
    b = Simulation(spec, device=device, backend="dense")
    ra = a.run(max_steps=50, time_save=20, verbose=False)
    rb = b.run(max_steps=50, time_save=50, verbose=False)
    torch.testing.assert_close(a.f, b.f, rtol=3e-6, atol=1e-7)
    assert abs(ra.velsum_series - rb.velsum_series).max() <= \
        1e-5 * abs(rb.velsum_series).min()


VESSELS = [("coronary", dict(shape=(64, 48, 96), radius=4)),
           ("coronary", dict(shape=(64, 48, 96), radius=4,
                             pulsatile=(4, 8))),
           ("curved_vessel", dict(n=32, nphase=4, period_steps=8))]


@pytest.mark.parametrize("name,kw", VESSELS)
def test_vessel_step_matches_plain(device, name, kw):
    """The whole kernel step (collide-stream over the live blocks, then
    lbm_fix_z_plane per z-plane outlet) against step_plain, 12 steps
    across 6 series phases."""
    cc = compile_case(get_case(name, **kw), device)
    f = initial_f(cc)
    fk, buf = f.clone(), f.clone()
    vs_k = torch.zeros(12, dtype=torch.float64, device=device)
    vs_p = torch.zeros(12, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(12):
        K.step(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        f, vs_p[t] = K.step_plain(f, cc, t)
    torch.cuda.synchronize()
    assert K.launches["lbm_collide_stream[bgk]"] == 12
    assert K.launches.get("lbm_fix_z_plane[bgk]", 0) == \
        12 * len(cc.z_bcs)
    torch.testing.assert_close(fk, f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)


def test_fix_z_plane_kernel_matches_plain(device):
    cc = compile_case(get_case("coronary", shape=(64, 48, 96), radius=4),
                      device)
    f0 = initial_f(cc)
    f1, _ = K.step_plain(f0, cc, 0)
    xy, _ = K.collide_stream_plain(f1, cc, 1)
    for bc in cc.z_bcs:
        a, b = xy.clone(), xy.clone()
        s = torch.zeros(1, dtype=torch.float64, device=device)
        K.fix_z_plane(f1, a, cc, bc, s, 0, 1)
        d = K.fix_z_plane_plain(f1, b, cc, bc, 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(a, b, rtol=3e-6, atol=1e-7)
        assert abs(float(s[0]) - float(d)) <= 1e-5 * abs(float(d)) + 1e-12


def test_live_block_launch_equals_the_full_launch(device):
    cc = compile_case(get_case("coronary", shape=(64, 48, 96), radius=4),
                      device)
    assert cc.live_blocks is not None
    f = initial_f(cc)
    f, _ = K.step_plain(f, cc, 0)
    s = torch.zeros(2, dtype=torch.float64, device=device)
    live = K.collide_stream(f, f.clone(), cc, s, 0, 1)
    full = K.collide_stream(f, f.clone(), cc, s, 1, 1, all_blocks=True)
    torch.cuda.synchronize()
    assert torch.equal(live, full)
    assert float(s[0]) == pytest.approx(float(s[1]), rel=1e-12)


CARREAU = {"model": "carreau", "nu0": 0.1, "nu_inf": 0.01, "lam": 100.0,
           "n": 0.4}
# branch -> (case, options, bit-equal to the plain version?)
BRANCHES = {
    "bgk+force": ("gravity_channel", dict(n=24, nz=24, fz=1e-4), True),
    "trt": ("lid_driven_cavity", dict(n=24, collision="trt"), True),
    "trt+force": ("gravity_channel", dict(n=24, nz=24, fz=1e-4,
                                          collision="trt"), True),
    "moving": ("lid_driven_cavity", dict(n=24, lid="bounceback"), True),
    "trt+moving": ("lid_driven_cavity", dict(n=24, lid="bounceback",
                                             collision="trt"), True),
    "mrt": ("lid_driven_cavity", dict(n=24, collision="mrt"), True),
    "smag": ("lid_driven_cavity", dict(n=24, smagorinsky_cs=0.15), False),
    "plaw": ("poiseuille", dict(n=24, rheology={
        "model": "power_law", "K": 0.02, "n": 0.7}), False),
    "cy": ("poiseuille", dict(n=24, rheology=CARREAU), False),
    "cy1.5": ("poiseuille", dict(n=24, rheology=dict(
        CARREAU, model="carreau_yasuda", a=1.5)), False),
    "casson": ("poiseuille", dict(n=24, rheology={
        "model": "casson", "nu_c": 0.02, "tau_y": 1e-5}), False),
    "trt+cy": ("lid_driven_cavity", dict(n=24, collision="trt",
                                         rheology=CARREAU), False),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_branch_kernel_matches_plain(device, branch):
    """Each collision branch of the collide-stream kernel against the
    plain step, 40 steps: bit for bit where the kernel repeats the dense
    step's arithmetic (MRT too: the same fp32 K in the same order), rtol
    3e-6 / atol 1e-7 for the closures (transcendentals); K3 with the
    case's force shift."""
    name, kw, exact = BRANCHES[branch]
    cc = compile_case(get_case(name, **kw), device)
    f = initial_f(cc)
    fk, buf = f.clone(), f.clone()
    vs_k = torch.zeros(40, dtype=torch.float64, device=device)
    vs_p = torch.zeros(40, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(40):
        K.step(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        f, vs_p[t] = K.step_plain(f, cc, t)
    torch.cuda.synchronize()
    assert K.launches == {f"lbm_collide_stream[{K.instance(cc)}]": 40}
    if exact:
        assert torch.equal(fk, f)
    else:
        torch.testing.assert_close(fk, f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)
    rho, u = K.macro(fk, cc.force)
    rho_p, u_p = K.macro_plain(fk, cc.force)
    assert torch.equal(rho, rho_p) and torch.equal(u, u_p)


def test_blood_closure_in_the_z_plane_fixup(device):
    """TRT + the Carreau blood closure on the pulsatile coronary: the
    z-plane fixup runs the same branch as the collide-stream kernel."""
    spec = get_case("coronary", shape=(64, 48, 96), radius=4,
                    pulsatile=(4, 8))
    spec = get_case("coronary", shape=(64, 48, 96), radius=4,
                    pulsatile=(4, 8), collision="trt",
                    rheology=carreau_blood(spec.units))
    cc = compile_case(spec, device)
    f = initial_f(cc)
    fk, buf = f.clone(), f.clone()
    vs_k = torch.zeros(12, dtype=torch.float64, device=device)
    vs_p = torch.zeros(12, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(12):
        K.step(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        f, vs_p[t] = K.step_plain(f, cc, t)
    torch.cuda.synchronize()
    assert K.launches["lbm_fix_z_plane[trt+cy]"] == 12 * len(cc.z_bcs)
    torch.testing.assert_close(fk, f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)


def test_kernel_refuses_mrt_with_a_force_on_the_card(device):
    spec = get_case("gravity_channel", n=16, nz=16, collision="mrt")
    with pytest.raises(NotImplementedError, match="backend='dense'"):
        Simulation(spec, device=device)
    sim = Simulation(spec, device=device, backend="dense")
    sim.run(max_steps=4, time_save=4, verbose=False)
    assert bool(torch.isfinite(sim.f).all())
