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
    # the lid at 32^3 has a fluid-cell list (its walls leave fewer than
    # 95% of the blocks live), the channel at 24^3 none
    counter = {"lid_driven_cavity": "lbm_collide_stream_list[bgk]",
               "poiseuille": "lbm_collide_stream[bgk]"}[name]
    f = initial_f(cc)
    fk, buf = f.clone(), f.clone()
    vs_k = torch.zeros(4, dtype=torch.float64, device=device)
    vs_p = torch.zeros(4, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(4):
        K.collide_stream(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        f, vs_p[t] = K.collide_stream_plain(f, cc, t)
    torch.cuda.synchronize()
    assert K.launches[counter] == 4
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
    """The whole kernel step (one collide-stream launch over the fluid
    cells, the z-plane outlets included) against step_plain, 12 steps
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
    assert K.launches == {"lbm_collide_stream_list[bgk]": 12}
    torch.testing.assert_close(fk, f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("inst", ["bgk", "trt+cy", "bgk+bf16", "bgk+halo"])
def test_fix_z_plane_kernel_matches_plain(device, inst):
    """The collide-stream kernel with the z-plane descriptors (the three
    sub-outlets of the small pulsatile coronary, which lbm_fix_z_plane
    fixed in launches of their own) against step_plain (the x/y pass
    plus each z window's fixup), one launch a step from a developed
    state, 8 steps: f bit for bit, velsum at 1e-5 relative; [trt+cy]
    (Carreau blood), bf16 storage and 2 shards along y (K1d) too."""
    from lbm_tpu_torch.bridge import shard_window
    from lbm_tpu_torch.engine.compile import compile_shard
    from lbm_tpu_torch.parallel.halo import ring_planes

    kw = dict(shape=(64, 48, 96), radius=4, pulsatile=(4, 8))
    if inst == "trt+cy":
        units = get_case("coronary", **kw).units
        kw.update(collision="trt", rheology=carreau_blood(units))
    spec = get_case("coronary", **kw)
    cc = compile_case(spec, device)
    assert len(cc.z_bcs) == 3 and len(cc.step_bcs) == 5
    f0 = initial_f(cc)
    for t in range(20):
        f0, _ = K.step_plain(f0, cc, t)
    if inst == "bgk+bf16":
        f0 = f0.to(torch.bfloat16)
    if inst == "bgk+halo":
        ccs = [compile_shard(spec, r, 2, 1, device) for r in range(2)]
        assert any(bc.window for c in ccs for bc in c.z_bcs)
        fk = [shard_window(f0, r, 2, 1) for r in range(2)]
    else:
        ccs, fk = [cc], [f0]
    bufs = [x.clone() for x in fk]
    fp = [x.clone() for x in fk]
    vk = torch.zeros(len(ccs), 8, dtype=torch.float64, device=device)
    vp = torch.zeros(len(ccs), 8, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(20, 28):
        halo_k = halo_p = [None] * len(ccs)
        if inst == "bgk+halo":
            halo_k = [c.halo(*p) for c, p in zip(ccs, ring_planes(fk, 1))]
            halo_p = [c.halo(*p) for c, p in zip(ccs, ring_planes(fp, 1))]
        for r, c in enumerate(ccs):
            K.collide_stream(fk[r], bufs[r], c, vk[r], t - 20, t,
                             halo=halo_k[r])
            fk[r], bufs[r] = bufs[r], fk[r]
            fp[r], vp[r, t - 20] = K.step_plain(fp[r], c, t, halo=halo_p[r])
    torch.cuda.synchronize()
    # fp32 over the fluid cells (the shards' too), bf16 by the paired kernel
    counter = {"bgk": "lbm_collide_stream_list[bgk]",
               "trt+cy": "lbm_collide_stream_list[trt+cy]",
               "bgk+bf16": "lbm_collide_stream[bgk+bf16]",
               "bgk+halo": "lbm_collide_stream_list[bgk+halo]"}[inst]
    assert K.launches == {counter: 8 * len(ccs)}
    for a, b in zip(fk, fp):
        if inst == "trt+cy":
            torch.testing.assert_close(a, b, rtol=3e-6, atol=1e-7)
        else:
            assert torch.equal(a, b)
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("how", ["trt+cy", "bgk, 2 shards along y"])
def test_fluid_launch_matches_plain_and_the_box(device, how):
    """The fp32 launch over the fluid cells (collide_stream_list_kernel:
    sector-aligned segments of each row's fluid runs, a word of wall links
    a lane) on the small pulsatile coronary, 8 steps from a 20-step
    state, with TRT + Carreau blood, or BGK on 2 shards along y (K1d, the
    links of the face rows from the neighbours' rows): each step against
    the launch over every cell of the box (all_blocks) from the same
    state, bit for bit, and the run against step_plain, bit for bit
    (Carreau blood: rtol 3e-6 / atol 1e-7); velsums at 1e-5."""
    from lbm_tpu_torch.bridge import shard_window
    from lbm_tpu_torch.engine.compile import compile_shard
    from lbm_tpu_torch.parallel.halo import ring_planes

    kw = dict(shape=(64, 48, 96), radius=4, pulsatile=(4, 8))
    if how == "trt+cy":
        units = get_case("coronary", **kw).units
        kw.update(collision="trt", rheology=carreau_blood(units))
    spec = get_case("coronary", **kw)
    cc = compile_case(spec, device)
    f0 = initial_f(cc)
    for t in range(20):
        f0, _ = K.step_plain(f0, cc, t)
    world = 1 if how == "trt+cy" else 2
    ccs = ([cc] if world == 1 else
           [compile_shard(spec, r, world, 1, device) for r in range(world)])
    fk = [f0 if world == 1 else shard_window(f0, r, world, 1)
          for r in range(world)]
    fp = [x.clone() for x in fk]
    vk = torch.zeros(world, 8, dtype=torch.float64, device=device)
    vb = torch.zeros(world, 8, dtype=torch.float64, device=device)
    vp = torch.zeros(world, 8, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(20, 28):
        halos = [None] * world
        halos_p = [None] * world
        if world > 1:
            halos = [c.halo(*p) for c, p in zip(ccs, ring_planes(fk, 1))]
            halos_p = [c.halo(*p) for c, p in zip(ccs, ring_planes(fp, 1))]
        for r, c in enumerate(ccs):
            assert c.fluid_cells is not None
            box = K.collide_stream(fk[r], fk[r].clone(), c, vb[r], t - 20, t,
                                   all_blocks=True, halo=halos[r])
            fk[r] = K.collide_stream(fk[r], fk[r].clone(), c, vk[r], t - 20,
                                     t, halo=halos[r])
            assert torch.equal(fk[r], box)
            fp[r], vp[r, t - 20] = K.step_plain(fp[r], c, t, halo=halos_p[r])
    torch.cuda.synchronize()
    tag = "+halo" if world > 1 else ""
    assert K.launches == {
        f"lbm_collide_stream_list[{K.instance(cc)}{tag}]": 8 * world,
        f"lbm_collide_stream[{K.instance(cc)}{tag}]": 8 * world}
    for a, b in zip(fk, fp):
        if how == "trt+cy":
            torch.testing.assert_close(a, b, rtol=3e-6, atol=1e-7)
        else:
            assert torch.equal(a, b)
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(vk, vb, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_live_block_launch_equals_the_full_launch(device, dtype):
    """The launch over the fluid-cell list against the launch over every
    cell of the box, each from out = f.clone(): bit-equal, velsums to
    rounding."""
    cc = compile_case(get_case("coronary", shape=(64, 48, 96), radius=4),
                      device)
    assert cc.live_blocks is not None and cc.fluid_cells is not None
    f = initial_f(cc)
    f, _ = K.step_plain(f, cc, 0)
    f = f.to(dtype)
    s = torch.zeros(2, dtype=torch.float64, device=device)
    live = K.collide_stream(f, f.clone(), cc, s, 0, 1)
    full = K.collide_stream(f, f.clone(), cc, s, 1, 1, all_blocks=True)
    torch.cuda.synchronize()
    assert torch.equal(live, full)
    assert float(s[0]) == pytest.approx(float(s[1]), rel=1e-12)


@pytest.mark.parametrize("how", ["fp32", "bf16", "halo y, 2 shards"])
def test_buffers_keep_equal_non_fluid_cells(device, how):
    """200 kernel steps of the pulsatile coronary (K1 over its fluid list
    and the z fixups; with a halo, K1d on 2 shards along y): the two
    ping-pong buffers' non-fluid cells stay bit-equal to each other and
    to the initial state, which the kernels never store."""
    from lbm_tpu_torch.bridge import shard_window
    from lbm_tpu_torch.engine.compile import compile_shard
    from lbm_tpu_torch.parallel.halo import ring_planes

    spec = get_case("coronary", shape=(64, 48, 96), radius=4,
                    pulsatile=(4, 8))
    cc = compile_case(spec, device)
    f0 = initial_f(cc).to(torch.bfloat16 if how == "bf16" else
                          torch.float32)
    if how.startswith("halo"):
        ccs = [compile_shard(spec, r, 2, 1, device) for r in range(2)]
        fs = [shard_window(f0, r, 2, 1) for r in range(2)]
        bufs = [x.clone() for x in fs]
        vs = torch.zeros(2, 200, dtype=torch.float64, device=device)
        for t in range(200):
            planes = ring_planes(fs, 1)
            for r, c in enumerate(ccs):
                K.step(fs[r], bufs[r], c, vs[r], t, t,
                       halo=c.halo(*planes[r]))
                fs[r], bufs[r] = bufs[r], fs[r]
        pairs = [(fs[r], bufs[r], shard_window(f0, r, 2, 1), c)
                 for r, c in enumerate(ccs)]
    else:
        f, buf = f0.clone(), f0.clone()
        vs = torch.zeros(200, dtype=torch.float64, device=device)
        for t in range(200):
            K.step(f, buf, cc, vs, t, t)
            f, buf = buf, f
        pairs = [(f, buf, f0, cc)]
    torch.cuda.synchronize()
    for a, b, init, c in pairs:
        keep = ~c.fluid[None].expand(19, *c.shape)
        assert torch.equal(a[keep], b[keep])
        assert torch.equal(a[keep], init[keep])
        assert not torch.equal(a[~keep], init[~keep])


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
# branch -> the launch counter of its step: over the fluid cells of the
# small boxes with a fluid-cell list, over the box of the channels without
BRANCH_COUNTERS = {
    "bgk+force": "lbm_collide_stream_list[bgk+force]",
    "trt": "lbm_collide_stream_list[trt]",
    "trt+force": "lbm_collide_stream_list[trt+force]",
    "moving": "lbm_collide_stream_list[bgk+moving]",
    "trt+moving": "lbm_collide_stream_list[trt+moving]",
    "mrt": "lbm_collide_stream_list[mrt]",
    "smag": "lbm_collide_stream_list[bgk+smag]",
    "plaw": "lbm_collide_stream[bgk+plaw]",
    "cy": "lbm_collide_stream[bgk+cy]",
    "cy1.5": "lbm_collide_stream[bgk+cy]",
    "casson": "lbm_collide_stream[bgk+casson]",
    "trt+cy": "lbm_collide_stream_list[trt+cy]",
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
    assert K.launches == {BRANCH_COUNTERS[branch]: 40}
    if exact:
        assert torch.equal(fk, f)
    else:
        torch.testing.assert_close(fk, f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)
    rho, u = K.macro(fk, cc.force)
    rho_p, u_p = K.macro_plain(fk, cc.force)
    assert torch.equal(rho, rho_p) and torch.equal(u, u_p)


def test_blood_closure_in_the_z_plane_fixup(device):
    """TRT + the Carreau blood closure on the pulsatile coronary: its
    z-plane outlets are rewritten in the collide-stream launch, with the
    same branch."""
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
    assert K.launches == {"lbm_collide_stream_list[trt+cy]": 12}
    torch.testing.assert_close(fk, f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)


def test_kernel_refuses_mrt_with_a_force_on_the_card(device):
    spec = get_case("gravity_channel", n=16, nz=16, collision="mrt")
    with pytest.raises(NotImplementedError, match="backend='dense'"):
        Simulation(spec, device=device)
    sim = Simulation(spec, device=device, backend="dense")
    sim.run(max_steps=4, time_save=4, verbose=False)
    assert bool(torch.isfinite(sim.f).all())


# -- scalar transport and thermal flow (K7, K8, K1e) ------------------------

def test_scalar_descriptor_offsets_equal_the_source_enums():
    """Needs no card: the parameter rows' offsets in
    kernels/scalar_stream.py against the enums of csrc/scalar_stream.cu,
    the boundary rows' widths and the most boundaries a launch takes."""
    import re

    import lbm_tpu_torch.kernels.scalar_stream as S
    from lbm_tpu_torch.kernels import _build

    src = _build.SCALAR_SOURCE.read_text()
    for prefix, table in (("SI", S.SINT), ("SF", S.SFLOAT)):
        enum = {m.group(1): int(m.group(2))
                for m in re.finditer(prefix + r"_(\w+) = (\d+)", src)}
        assert enum == table
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kBCInts"], consts["kBCFloats"], consts["kMaxBCs"]) == (
        S.BC_INTS, S.BC_FLOATS, S.MAX_BCS)
    assert consts["kBlock"] == 256
    src = _build.HEADER.read_text()
    enum = {m.group(1): int(m.group(2))
            for m in re.finditer(r"CF_(\w+) = (\d+)", src)}
    assert enum == K.CFLOAT
    assert "kFieldForce = 2" in src and K.FIELD_FORCE == 2


def _transports(make, device):
    """(kernel route on the card, a twin stepped with the plain versions)."""
    return make(device=device, backend="kernel"), \
        make(device=device, backend="kernel")


def _run_plain(tr, n, record):
    """n steps of tr's state with the kernel route's plain versions; the
    (n, n_bc) record series."""
    import lbm_tpu_torch.kernels.scalar_stream as S

    series = torch.zeros((n, len(tr.sc.bcs)), dtype=torch.float64,
                         device=tr.sc.device)
    for k in range(n):
        if hasattr(tr, "cc"):
            tr.f, tr.g, series[k], _ = S.coupled_step_plain(
                tr.f, tr.g, tr.cc, tr.sc, tr.t + k, tr.field)
        else:
            tr.g, series[k] = S.scalar_stream_plain(tr.g, tr.sc, tr.t + k)
    tr.t += n
    return series[:, record].cpu().numpy()


FROZEN = {
    "frozen+comp": ("poiseuille", dict(n=24), dict(inlet_c={0: 1.0})),
    "frozen": ("coronary", dict(shape=(64, 48, 96), radius=4),
               dict(inlet_c={0: 0.0}, source=1.0, div_fix=False)),
    "frozen+comp bolus": ("coronary", dict(shape=(64, 48, 96), radius=4),
                          dict(inlet_c={0: lambda t: 1.0 if t < 10 else 0.0})),
}


@pytest.mark.parametrize("label", sorted(FROZEN))
def test_scalar_kernel_frozen_matches_plain(device, label):
    """K7: the frozen-field instances against the plain pass, 40 steps,
    bit for bit; the record series to 1e-12."""
    import lbm_tpu_torch.kernels.scalar_stream as S
    from lbm_tpu_torch.engine.scalar import ScalarTransport

    name, kw, tkw = FROZEN[label]
    spec = get_case(name, **kw)
    sim = Simulation(spec, device=device)
    sim.run(max_steps=40, time_save=40, verbose=False)
    u = sim.macro()[1]
    a, b = _transports(lambda **d: ScalarTransport(spec, u, D=0.02, **tkw,
                                                   **d), device)
    rec = list(range(len(spec.boundaries)))
    S.reset_launches()
    sa = a.run(40, record=rec)
    sb = _run_plain(b, 40, rec)
    torch.cuda.synchronize()
    assert S.launches == {
        f"lbm_scalar_stream[{S.instance(a.sc, False)}]": 40}
    assert S.instance(a.sc, False) == label.split()[0]
    assert torch.equal(a.g, b.g)
    assert abs(sa - sb).max() <= 1e-12
    assert a.total() > 0


def test_scalar_kernel_coupled_matches_plain(device):
    """K8 behind the flow kernels on the pulsatile small coronary."""
    import lbm_tpu_torch.kernels.scalar_stream as S
    from lbm_tpu_torch.engine.scalar import CoupledTransport

    spec = get_case("coronary", shape=(64, 48, 96), radius=4,
                    pulsatile=(4, 8))
    a, b = _transports(lambda **d: CoupledTransport(
        spec, D=0.02, inlet_c={0: 1.0}, **d), device)
    rec = list(range(len(spec.boundaries)))
    S.reset_launches()
    K.reset_launches()
    sa = a.run(24, record=rec)
    sb = _run_plain(b, 24, rec)
    torch.cuda.synchronize()
    assert S.launches == {"lbm_scalar_stream[live]": 24}
    assert K.launches["lbm_collide_stream_list[bgk]"] == 24
    assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
    assert abs(sa - sb).max() <= 1e-12


@pytest.mark.parametrize("live", [False, True])
def test_scalar_kernel_over_the_cell_list(device, live):
    """K7 (frozen u) and K8 (the flow's post-collision state) launched
    over the scalar's cell list (the fluid cells and the footprints' cells
    on their consumer planes) on the small pulsatile coronary, a bolus at
    the inlet and every plane recorded, 20 steps from a random g: against
    the plain pass and against the launch over every cell of the box, g
    bit for bit and the records within 1e-12 (the record sums the
    footprints' lists of lateral indices)."""
    import dataclasses

    import numpy as np

    import lbm_tpu_torch.kernels.scalar_stream as S
    from lbm_tpu_torch.engine.scalar import (
        CoupledTransport,
        ScalarTransport,
    )

    spec = get_case("coronary", shape=(64, 48, 96), radius=4,
                    pulsatile=(4, 8))
    c0 = np.random.default_rng(1).random(tuple(spec.shape), dtype=np.float32)
    inlet = {0: lambda t: 1.0 if t < 10 else 0.0}
    if live:
        tr = CoupledTransport(spec, D=0.02, inlet_c=inlet, c0=c0,
                              device=device)
        for t in range(20):
            tr.f, _ = K.step_plain(tr.f, tr.cc, t)
        f = tr.f
    else:
        sim = Simulation(spec, device=device)
        sim.run(max_steps=40, time_save=40, verbose=False)
        tr = ScalarTransport(spec, sim.macro()[1], D=0.02, inlet_c=inlet,
                             c0=c0, device=device)
        f = None
    sc = tr.sc
    assert sc.cells is not None and sc.cells.numel() >= int(sc.fluid.sum())
    full = dataclasses.replace(sc, cells=None)
    n_bc = len(sc.bcs)
    g = {"list": tr.g.clone(), "full": tr.g.clone()}
    buf = {k: v.clone() for k, v in g.items()}
    series = {k: torch.zeros((20, n_bc), dtype=torch.float64,
                             device=device) for k in g}
    gp, want = tr.g.clone(), []
    S.reset_launches()
    for t in range(20):
        for key, case in (("list", sc), ("full", full)):
            S.scalar_stream(g[key], buf[key], case, t, f=f,
                            series=series[key], slot=t)
            g[key], buf[key] = buf[key], g[key]
        gp, rec = S.scalar_stream_plain(gp, sc, t, f=f)
        want.append(rec)
    torch.cuda.synchronize()
    assert S.launches == {
        f"lbm_scalar_stream[{S.instance(sc, live)}]": 40}
    assert torch.equal(g["list"], gp) and torch.equal(g["full"], gp)
    want = torch.stack(want)
    assert float((series["list"] - want).abs().max()) <= 1e-12
    assert float((series["full"] - want).abs().max()) <= 1e-12
    assert float(want[:, 0].max()) > 0


THERMAL = {
    "cavity3d": ("heated_cavity_3d", dict(n=24), {}),
    "cavity3d trt": ("heated_cavity_3d", dict(n=24), dict(collision="trt")),
    "rb3d": ("rayleigh_benard_3d", dict(nx=32, ny=32, nz=18), {}),
    "rb periodic": ("rayleigh_benard", dict(nx=32, ny=1, nz=18), {}),
    "cavity periodic": ("heated_cavity", dict(n=26), {}),
}


@pytest.mark.parametrize("label", sorted(THERMAL))
def test_thermal_kernels_match_plain(device, label):
    """K1e + K8 with Dirichlet walls against their plain versions, 40
    steps, bit for bit in f and g."""
    import dataclasses

    import lbm_tpu_torch.kernels.scalar_stream as S
    from lbm_tpu_torch.cases import thermal as tc
    from lbm_tpu_torch.engine.thermal import BuoyantTransport

    name, kw, opts = THERMAL[label]
    spec, tkw, _ = getattr(tc, name)(**kw)
    spec = dataclasses.replace(spec, **opts)
    a, b = _transports(lambda **d: BuoyantTransport(spec, **tkw, **d), device)
    S.reset_launches()
    K.reset_launches()
    a.run(40)
    _run_plain(b, 40, [])
    torch.cuda.synchronize()
    assert K.instance(a.cc, a.field) == \
        f"{opts.get('collision', 'bgk')}+field"
    assert K.launches == {
        f"lbm_collide_stream[{opts.get('collision', 'bgk')}+field]": 40}
    assert S.launches == {"lbm_scalar_stream[live+force+dirichlet]": 40}
    assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
    rho, u = a.macro()
    assert bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0


@pytest.mark.parametrize("coll", ["bgk", "trt"])
@pytest.mark.parametrize("sliding", [False, True])
def test_force_field_with_z_planes_and_moving_walls(device, coll, sliding):
    """The force-field instances of the collide-stream kernel with z-plane
    descriptors, and their +moving ones: a buoyant scalar in the small
    pulsatile tree (three z-plane boundaries), the walls of its x < 32
    half sliding along z or not; 40 steps, bit for bit in f and g."""
    import dataclasses

    import numpy as np

    import lbm_tpu_torch.kernels.scalar_stream as S
    from lbm_tpu_torch.engine.thermal import BuoyantTransport
    from lbm_tpu_torch.geometry.mask import CellType

    spec = get_case("coronary", shape=(64, 48, 96), radius=4,
                    pulsatile=(4, 8), collision=coll)
    if sliding:
        mask = np.array(spec.mask)
        mask[:32][mask[:32] == int(CellType.WALL)] = int(CellType.MOVING)
        spec = dataclasses.replace(spec, mask=mask,
                                   wall_velocity=(0.0, 0.0, 1e-3))
    c0 = np.random.default_rng(0).random(tuple(spec.shape), dtype=np.float32)
    a, b = _transports(lambda **d: BuoyantTransport(
        spec, D=0.02, buoyancy=(0.0, 1e-4, 2e-4), c_ref=0.5, c0=c0,
        inlet_c={0: 1.0}, **d), device)
    S.reset_launches()
    K.reset_launches()
    a.run(40)
    _run_plain(b, 40, [])
    torch.cuda.synchronize()
    inst = f"{coll}+field" + ("+moving" if sliding else "")
    assert K.launches == {f"lbm_collide_stream_list[{inst}]": 40}
    assert S.launches == {"lbm_scalar_stream[live+force]": 40}
    assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
    assert float(a.concentration().abs().max()) > 0


def test_thermal_kernel_route_refusals_on_the_card(device):
    import dataclasses

    from lbm_tpu_torch.cases import thermal as tc
    from lbm_tpu_torch.engine.thermal import BuoyantTransport

    spec, tkw, _ = tc.heated_cavity_3d(n=12)
    for opts in (dict(collision="mrt"), dict(force=(0.0, 0.0, 1e-6))):
        with pytest.raises(NotImplementedError, match="backend='dense'"):
            BuoyantTransport(dataclasses.replace(spec, **opts), **tkw,
                             device=device)


# the fused pair's instances: (case, options, bit-equal to two single
# steps and the plain version?)
PAIRS = {
    "bgk": ("lid_driven_cavity", dict(n=32), True),
    "trt": ("lid_driven_cavity", dict(n=32, collision="trt"), True),
    "mrt": ("lid_driven_cavity", dict(n=32, collision="mrt"), True),
    "moving": ("lid_driven_cavity", dict(n=32, lid="bounceback"), True),
    "trt+moving": ("lid_driven_cavity", dict(n=32, lid="bounceback",
                                             collision="trt"), True),
    "mrt+moving": ("lid_driven_cavity", dict(n=32, lid="bounceback",
                                             collision="mrt"), True),
    "smag": ("lid_driven_cavity", dict(n=32, smagorinsky_cs=0.15), False),
    "trt+cy": ("lid_driven_cavity", dict(n=32, collision="trt",
                                         rheology=CARREAU), False),
    "bgk+force": ("gravity_channel", dict(n=32, nz=32, fz=1e-4), True),
    "trt+force": ("gravity_channel", dict(n=32, nz=32, fz=1e-4,
                                          collision="trt"), True),
    "casson": ("poiseuille", dict(n=24, rheology={
        "model": "casson", "nu_c": 0.02, "tau_y": 1e-5}), False),
}


def _pair_run(cc, steps, device):
    """`steps` steps three ways from the same state: step2 launches, K1
    launches, the plain pair. Returns (f, velsums) of each."""
    f0 = initial_f(cc)
    runs = []
    for how in ("pair", "single", "plain"):
        f, buf = f0.clone(), f0.clone()
        vs = torch.zeros(steps, dtype=torch.float64, device=device)
        for t in range(0, steps, 2):
            if how == "pair":
                K.step2(f, buf, cc, vs, t, t)
                f, buf = buf, f
            elif how == "single":
                for k in (t, t + 1):
                    K.collide_stream(f, buf, cc, vs, k, k)
                    f, buf = buf, f
            else:
                f, vs[t], vs[t + 1] = K.collide_stream2_plain(f, cc, t)
        runs.append((f, vs))
    torch.cuda.synchronize()
    return runs


@pytest.mark.parametrize("branch", sorted(PAIRS))
def test_pair_kernel_matches_two_single_steps_and_plain(device, branch):
    """K2 (lbm_collide_stream2) against two K1 launches and the plain
    pair, 40 steps (20 launches): f bit for bit where K1 is (the closures
    at rtol 3e-6 / atol 1e-7 against the plain version), velsums at 1e-5
    relative."""
    name, kw, exact = PAIRS[branch]
    cc = compile_case(get_case(name, **kw), device)
    K.reset_launches()
    (fp, vp), (fs, vs), (fq, vq) = _pair_run(cc, 40, device)
    inst = K.instance(cc)
    # K1 over the fluid cells of the small boxes, over the channel's box
    k1 = ("lbm_collide_stream" if branch == "casson"
          else "lbm_collide_stream_list")
    assert K.launches == {f"lbm_collide_stream2[{inst}]": 20,
                          f"{k1}[{inst}]": 40}
    assert torch.equal(fp, fs)
    if exact:
        assert torch.equal(fp, fq)
    else:
        torch.testing.assert_close(fp, fq, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vp, vs, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(vp, vq, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("name,kw", [
    ("gravity_channel", dict(n=20, nz=3, collision="trt")),   # z of 3 cells
    ("pipe", dict(n=36, curved=False)),                       # 36 = 4.5 tiles
    ("curved_vessel", dict(n=24, nphase=4, period_steps=4)),  # phase a step
    ("gravity_channel", dict(n=70, nz=45, collision="trt")),  # 2 segments,
    ("lid_driven_cavity", dict(n=66)),                        # ragged tiles
])
def test_pair_kernel_on_boxes_the_tile_does_not_fit(device, name, kw):
    """Ceil-div units (an x segment of 64 planes, an 8 x 32 column tile),
    an axis shorter than the tile, z rows that are not 16-byte aligned
    (nz 3, 45, 66: the element copies), two segments along x, a series
    inlet whose phase changes between the two steps of a pair: 24 steps,
    bit for bit against two K1 launches and the plain pair."""
    cc = compile_case(get_case(name, **kw), device)
    (fp, vp), (fs, vs), (fq, vq) = _pair_run(cc, 24, device)
    assert torch.equal(fp, fs) and torch.equal(fp, fq)
    torch.testing.assert_close(vp, vq, rtol=1e-5, atol=0.0)


def test_pair_live_tile_launch_equals_the_full_launch(device):
    cc = compile_case(get_case("curved_vessel", n=64, nphase=4,
                               period_steps=8), device)
    assert cc.live_tiles is not None
    f = initial_f(cc)
    f, _, _ = K.collide_stream2_plain(f, cc, 0)
    s = torch.zeros(4, dtype=torch.float64, device=device)
    live = K.step2(f, f.clone(), cc, s, 0, 2)
    full = K.step2(f, f.clone(), cc, s, 2, 2, all_tiles=True)
    torch.cuda.synchronize()
    assert torch.equal(live, full)
    assert s[:2].tolist() == pytest.approx(s[2:].tolist(), rel=1e-12)


def test_extract_rows_kernel_matches_narrow(device):
    f = torch.randn(19, 13, 12, 10, device=device)
    g = torch.randn(19, 9, 7, 5, device=device)   # rows not 16-byte aligned
    K.reset_launches()
    for x, x0, wx in ((f, 0, 13), (f, 5, 3), (g, 2, 4), (g, 8, 1)):
        out = K.extract_rows(x, x0, wx)
        assert torch.equal(out, x.narrow(1, x0, wx).contiguous())
    assert K.launches == {"lbm_extract_rows": 4}
    sim = Simulation(get_case("lid_driven_cavity", n=24), device=device,
                     lowmem=True)
    sim.run(max_steps=4, time_save=4, verbose=False)
    host = sim.f_standard()
    assert host.device.type == "cpu" and torch.equal(host, sim.f.cpu())


def test_runner_odd_tail_runs_one_single_step(device):
    """fuse=2 with an odd chunk: n // 2 pairs and one K1 step a chunk;
    f bit for bit and velsums at 1e-5 against fuse=1."""
    spec = get_case("lid_driven_cavity", n=32)
    a = Simulation(spec, device=device, fuse=2)
    b = Simulation(spec, device=device)
    K.reset_launches()
    ra = a.run(max_steps=14, time_save=7, verbose=False)
    assert K.launches == {"lbm_collide_stream2[bgk]": 6,
                          "lbm_collide_stream_list[bgk]": 2}
    rb = b.run(max_steps=14, time_save=7, verbose=False)
    assert torch.equal(a.f, b.f)
    assert abs(ra.velsum_series - rb.velsum_series).max() <= \
        1e-5 * abs(rb.velsum_series).min()


# -- bf16 storage ----------------------------------------------------------

# every bf16 collide-stream instance: BRANCHES and BGK (bit-equal to the
# plain version where the fp32 instance is)
BF16_BRANCHES = dict(BRANCHES, bgk=("lid_driven_cavity", dict(n=24), True))


def _close_bf16(got, want):
    """A closure's bf16 state against its plain version: within 2e-2 of
    max |f|, lbm_tpu's bf16 bound (the fp32 transcendentals differ in the
    last bit, which a narrowing can carry into a bf16 ulp)."""
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-2 * float(want.float().abs().max()), err


@pytest.mark.parametrize("branch", sorted(BF16_BRANCHES))
def test_bf16_branch_kernel_matches_plain(device, branch):
    """Each bf16 collide-stream instance against the plain step on bf16
    state, 40 steps: f bit for bit where the fp32 instance is, the
    closures within lbm_tpu's bf16 bound; velsums at 1e-5 relative; K3 on
    the bf16 state bit for bit, with the case's force shift."""
    name, kw, exact = BF16_BRANCHES[branch]
    cc = compile_case(get_case(name, **kw), device)
    f = initial_f(cc).to(torch.bfloat16)
    fk, buf = f.clone(), f.clone()
    vs_k = torch.zeros(40, dtype=torch.float64, device=device)
    vs_p = torch.zeros(40, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(40):
        K.step(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        f, vs_p[t] = K.step_plain(f, cc, t)
    torch.cuda.synchronize()
    assert K.launches == {f"lbm_collide_stream[{K.instance(cc)}+bf16]": 40}
    assert fk.dtype == f.dtype == torch.bfloat16
    if exact:
        assert torch.equal(fk, f)
    else:
        _close_bf16(fk, f)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)
    rho, u = K.macro(fk, cc.force)
    rho_p, u_p = K.macro_plain(fk, cc.force)
    assert torch.equal(rho, rho_p) and torch.equal(u, u_p)


@pytest.mark.parametrize("name,kw", VESSELS)
def test_bf16_vessel_step_matches_plain(device, name, kw):
    """The bf16 step on the vessels (the fluid list, the z planes in the
    same launch, series phases), 12 steps, bit for bit against
    step_plain on bf16 state."""
    cc = compile_case(get_case(name, **kw), device)
    f = initial_f(cc).to(torch.bfloat16)
    fk, buf = f.clone(), f.clone()
    vs_k = torch.zeros(12, dtype=torch.float64, device=device)
    vs_p = torch.zeros(12, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(12):
        K.step(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        f, vs_p[t] = K.step_plain(f, cc, t)
    torch.cuda.synchronize()
    assert K.launches == {"lbm_collide_stream[bgk+bf16]": 12}
    assert torch.equal(fk, f)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("branch", sorted(PAIRS))
def test_bf16_pair_kernel_matches_plain(device, branch):
    """The bf16 fused pair (fp32 mid tile, one narrowing a pair) against
    the plain pair on bf16 state, 40 steps: bit for bit where the fp32
    pair is, the closures within lbm_tpu's bf16 bound; velsums at 1e-5.
    Two bf16 K1 launches narrow in between and need not agree."""
    name, kw, exact = PAIRS[branch]
    cc = compile_case(get_case(name, **kw), device)
    f0 = initial_f(cc).to(torch.bfloat16)
    fp, buf = f0.clone(), f0.clone()
    fq = f0
    vp = torch.zeros(40, dtype=torch.float64, device=device)
    vq = torch.zeros(40, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(0, 40, 2):
        K.step2(fp, buf, cc, vp, t, t)
        fp, buf = buf, fp
        fq, vq[t], vq[t + 1] = K.collide_stream2_plain(fq, cc, t)
    torch.cuda.synchronize()
    assert K.launches == {f"lbm_collide_stream2[{K.instance(cc)}+bf16]": 20}
    if exact:
        assert torch.equal(fp, fq)
    else:
        _close_bf16(fp, fq)
    torch.testing.assert_close(vp, vq, rtol=1e-5, atol=0.0)


# The paired bf16 kernel's edges (case, options): an odd nz (the last z
# cell a pair of its own, rows that start at odd elements) with z planes
# on the even halves of their pairs; z planes on the odd halves; an odd
# cell count (every direction's plane at the other parity), a force and a
# moving lid; walls beside fluid cells inside one pair in each.
PAIR_EDGES = {
    "odd nz, z planes on even halves": (
        "coronary", dict(shape=(64, 48, 95), radius=4, pulsatile=(4, 8))),
    "z planes on odd halves": (
        "coronary", dict(shape=(64, 48, 96), radius=4, pulsatile=(4, 8))),
    "odd cell count, trt+force": (
        "gravity_channel", dict(n=23, nz=25, fz=1e-4, collision="trt")),
    "odd cell count, moving lid": (
        "lid_driven_cavity", dict(n=25, lid="bounceback")),
}


@pytest.mark.parametrize("label", sorted(PAIR_EDGES))
def test_bf16_paired_kernel_edges(device, label):
    """The paired bf16 kernel over its pair list (where the case has one)
    and over the box, 40 steps each against step_plain on bf16 state: f
    bit for bit, velsums at 1e-5 relative; a non-fluid cell (a wall half
    of a pair included) keeps its initial words in both buffers."""
    name, kw = PAIR_EDGES[label]
    cc = compile_case(get_case(name, **kw), device)
    f0 = initial_f(cc).to(torch.bfloat16)
    fp = f0
    vs_p = torch.zeros(40, dtype=torch.float64, device=device)
    for t in range(40):
        fp, vs_p[t] = K.step_plain(fp, cc, t)
    keep = ~cc.fluid[None].expand(19, *cc.shape)
    for all_blocks in ((False, True) if cc.fluid_pairs is not None
                       else (True,)):
        fk, buf = f0.clone(), f0.clone()
        vs_k = torch.zeros(40, dtype=torch.float64, device=device)
        K.reset_launches()
        for t in range(40):
            K.step(fk, buf, cc, vs_k, t, t, all_blocks)
            fk, buf = buf, fk
        torch.cuda.synchronize()
        assert K.launches == {
            f"lbm_collide_stream[{K.instance(cc)}+bf16]": 40}
        assert torch.equal(fk, fp), all_blocks
        torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)
        assert torch.equal(fk[keep], f0[keep])
        assert torch.equal(buf[keep], f0[keep])


# div_exact's hard divisors (significands of all ones, where one
# correction misses) and 1
@pytest.mark.parametrize("b", [0.99999994, 1.9999999, 0.49999997, 1.0])
def test_div_exact_matches_ieee_division(device, b):
    """The paired kernel's division against IEEE a / b over all 2^32 fp32
    dividends (every exponent and significand, zeros, subnormals, inf and
    NaN): no quotient differs, and the host's reciprocal of a launch
    divisor equals __frcp_rn."""
    bad, rcp_equal = K.div_exact_check(b, device)
    assert bad == 0 and rcp_equal


def test_bf16_extract_rows_and_lowmem_read(device):
    f = torch.randn(19, 13, 12, 16, device=device).to(torch.bfloat16)
    g = torch.randn(19, 9, 7, 5, device=device).to(torch.bfloat16)
    K.reset_launches()
    for x, x0, wx in ((f, 0, 13), (f, 5, 3), (g, 2, 4), (g, 8, 1)):
        out = K.extract_rows(x, x0, wx)
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, x.narrow(1, x0, wx).contiguous())
    assert K.launches == {"lbm_extract_rows[bf16]": 4}
    sim = Simulation(get_case("lid_driven_cavity", n=24), device=device,
                     lowmem=True, store_dtype="bf16")
    sim.run(max_steps=4, time_save=4, verbose=False)
    host = sim.f_standard()
    assert host.device.type == "cpu" and host.dtype == torch.float32
    assert torch.equal(host, sim.f.float().cpu())


# the sharded step (K1d): branch -> (case, options, shard axes, bit-equal
# to the plain version?)
HALO_BRANCHES = {
    "bgk": ("lid_driven_cavity", dict(n=24), (0,), True),
    "bgk z outlets": ("coronary", dict(shape=(64, 48, 96), radius=4,
                                       pulsatile=(4, 8)), (1,), True),
    "bgk+force": ("gravity_channel", dict(n=24, nz=24, fz=1e-4), (0, 1),
                  True),
    "trt": ("coronary", dict(shape=(64, 48, 96), radius=4,
                             collision="trt"), (1,), True),
    "trt+force": ("gravity_channel", dict(n=24, nz=24, fz=1e-4,
                                          collision="trt"), (0, 1), True),
    "moving": ("lid_driven_cavity", dict(n=24, lid="bounceback"), (0, 1),
               True),
    "trt+moving": ("lid_driven_cavity", dict(n=24, lid="bounceback",
                                             collision="trt"), (0, 1), True),
    "mrt": ("coronary", dict(shape=(64, 48, 96), radius=4,
                             collision="mrt"), (1,), True),
    "mrt x": ("lid_driven_cavity", dict(n=24, collision="mrt"), (0,), True),
    "smag": ("lid_driven_cavity", dict(n=24, smagorinsky_cs=0.15), (0,),
             False),
    "cy": ("poiseuille", dict(n=24, rheology=CARREAU), (0,), False),
    "trt+cy": ("coronary", dict(shape=(64, 48, 96), radius=4,
                                collision="trt", rheology=CARREAU), (1,),
               False),
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("branch", sorted(HALO_BRANCHES))
def test_halo_kernels_match_plain_and_the_whole_box(device, branch, world):
    """The sharded collide-stream kernel (K1d, its z planes in the same
    launch) on `world` shards held in one process, 20 steps: each shard against the plain
    halo step (bit for bit but for the closures, rtol 3e-6 / atol 1e-7),
    and the stitched shards against the whole-box kernel step, bit for
    bit where the plain versions are."""
    from lbm_tpu_torch.bridge import gather_windows, shard_window
    from lbm_tpu_torch.engine.compile import compile_shard
    from lbm_tpu_torch.parallel.halo import ring_planes

    name, kw, axes, exact = HALO_BRANCHES[branch]
    spec = get_case(name, **kw)
    for axis in axes:
        cc = compile_case(spec, device)
        ccs = [compile_shard(spec, r, world, axis, device)
               for r in range(world)]
        f = initial_f(cc)
        whole, buf = f.clone(), f.clone()
        fk = [shard_window(f, r, world, axis) for r in range(world)]
        bufs = [x.clone() for x in fk]
        fp = [x.clone() for x in fk]
        vk = torch.zeros(world, 20, dtype=torch.float64, device=device)
        vp = torch.zeros(world, 20, dtype=torch.float64, device=device)
        vw = torch.zeros(20, dtype=torch.float64, device=device)
        K.reset_launches()
        for t in range(20):
            K.step(whole, buf, cc, vw, t, t)
            whole, buf = buf, whole
            planes_k, planes_p = ring_planes(fk, axis), ring_planes(fp, axis)
            for r, c in enumerate(ccs):
                K.step(fk[r], bufs[r], c, vk[r], t, t,
                       halo=c.halo(*planes_k[r]))
                fk[r], bufs[r] = bufs[r], fk[r]
                fp[r], vp[r, t] = K.step_plain(fp[r], c, t,
                                               halo=c.halo(*planes_p[r]))
        torch.cuda.synchronize()
        # each shard's K1d over its fluid cells where it has a fluid-cell
        # list: every shard but the two middle ones of a small box split
        # in 4 along x; the channel (cy) has none
        listed = [branch != "cy" and not (world == 4 and axis == 0
                                          and r in (1, 2))
                  for r in range(world)]
        want = [("lbm_collide_stream_list" if x else "lbm_collide_stream")
                + f"[{K.instance(cc)}+halo]" for x in listed]
        whole_k1 = "lbm_collide_stream" if branch == "cy" else \
            "lbm_collide_stream_list"
        assert K.launches == {f"{whole_k1}[{K.instance(cc)}]": 20,
                              **{w: 20 * want.count(w) for w in want}}
        stitched = gather_windows(fk, axis, spec.shape[axis])
        for r in range(world):
            if exact:
                assert torch.equal(fk[r], fp[r])
            else:
                torch.testing.assert_close(fk[r], fp[r], rtol=3e-6,
                                           atol=1e-7)
        if exact:
            assert torch.equal(stitched, whole)
        else:
            torch.testing.assert_close(stitched, whole, rtol=3e-6,
                                       atol=1e-7)
        torch.testing.assert_close(vk.sum(0), vw, rtol=1e-12, atol=0.0)
        torch.testing.assert_close(vk, vp, rtol=1e-5, atol=0.0)


def test_sharded_simulation_on_one_card(device):
    """Simulation(mesh=) on 2 gloo ranks sharing the card (the planes
    staged through host memory), the coronary split along y: its
    gathered state equals the whole-box run's bit for bit off the DEAD
    cells, zeros on them; K1d, the z planes in its launch, every step."""
    from lbm_tpu_torch.parallel.launch import run_case, spawn

    opts = dict(shape=(64, 48, 96), radius=4, pulsatile=(4, 8))
    out = spawn(run_case, 2, ("coronary", opts, "kernel", 12, 6),
                backend="gloo", device="cuda", timeout=120)[0]
    sim = Simulation(get_case("coronary", **opts), device=device)
    sim.run(max_steps=12, time_save=6, verbose=False)
    f = sim.f_standard().cpu().numpy()
    live = sim.spec.mask != 0
    assert (out["f"][:, live] == f[:, live]).all()
    assert (out["f"][:, ~live] == 0).all()
    assert out["launches"]["lbm_collide_stream_list[bgk+halo]"] == 12
    assert not [k for k in out["launches"] if "fix_z_plane" in k]


def test_sharded_scalar_kernel_on_one_card(device):
    """ScalarTransport(mesh=, backend='kernel') on 2 gloo ranks sharing the
    card, the steady coronary (64, 48, 96) r=4 split along y with a bolus:
    K7 on each rank's halo-row block (its crossing channel staged through
    host memory into the halo rows), the gathered g bit for bit against
    the plain pass of the whole box on the card (the dense route), the
    records at rtol 2e-6 / atol 1e-8; K7 [frozen+comp] once a step on
    every rank."""
    import numpy as np

    from lbm_tpu_torch.engine.scalar import ScalarTransport
    from lbm_tpu_torch.parallel.launch import Gate, run_transport, spawn

    opts = dict(shape=(64, 48, 96), radius=4)
    spec = get_case("coronary", **opts)
    sim = Simulation(spec, device=device)
    sim.run(max_steps=100, time_save=100, verbose=False)
    u = sim.macro()[1].cpu().numpy()
    kw = dict(D=0.02, inlet_c={0: Gate(20)})
    outs = spawn(run_transport, 2, (("case", "coronary", opts), "scalar",
                                    dict(kw, backend="kernel", shard_axis=1),
                                    40, [0, 1, 2], u),
                 backend="gloo", device="cuda", timeout=120)
    plain = ScalarTransport(spec, u, device=device, backend="dense", **kw)
    series = plain.run(40, record=[0, 1, 2])
    assert (outs[0]["g"] == plain.g.cpu().numpy()).all()
    np.testing.assert_allclose(outs[0]["series"], series, rtol=2e-6,
                               atol=1e-8)
    for out in outs:
        assert out["launches"] == {"lbm_scalar_stream[frozen+comp]": 40}


WK4 = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3), (1e-4, 5e3, 4e-3),
       (1e-4, 5e3, 8e-3)]
WK_CASES = {
    "coronary": ("coronary", dict(shape=(48, 24, 40), radius=5,
                                  windkessel=WK4, pulsatile=(4, 8))),
    "coronary+trt+cy": ("coronary", dict(
        shape=(48, 24, 40), radius=5, windkessel=WK4, collision="trt",
        rheology={"model": "carreau", "nu0": 0.05, "nu_inf": 0.005,
                  "lam": 10.0, "n": 0.5})),
    "poiseuille": ("poiseuille", dict(n=16,
                                      windkessel=(5e-4, 24000.0, 2.5e-3))),
}


@pytest.mark.parametrize("label", sorted(WK_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windkessel_flux_and_planes_match_plain(device, label, dtype):
    """From a developed state (80 float32 steps of the case on the card,
    then stored in `dtype`; Q != 0 at every outlet of the coronaries):
    the flux kernel's prime (terms and Q) equals wk_terms_plain, and the
    fold launch with its reduction equals step_wk_plain over 20 steps,
    f, P_c, the staged Q and the terms, and stays lbm_tpu's order (a flux
    from each pre-step state, then the step)."""
    from lbm_tpu_torch.engine.compile import wk_init

    name, kw = WK_CASES[label]
    spec = get_case(name, **kw)
    dev = Simulation(spec, device=device)
    dev.run(max_steps=80, time_save=80, verbose=False)
    cc = dev.cc
    f = dev.f.to(dtype)
    wk0 = dev.wk.clone()
    assert not torch.equal(wk0, torch.from_numpy(wk_init(cc.bcs)).to(device))
    fk, buf = f.clone(), f.clone()
    wk_k, wk_p = wk0.clone(), wk0.clone()
    terms_p, q_p = K.wk_terms_plain(f, cc)
    if name == "coronary":
        assert (q_p != 0).all()
    K.reset_launches()
    stage = K.windkessel_prime(fk, cc)
    assert torch.equal(stage.terms, terms_p) and torch.equal(stage.q, q_p)
    vs_k = torch.zeros(20, dtype=torch.float64, device=device)
    vs_p = torch.zeros(20, dtype=torch.float64, device=device)
    g, wk_g = f.clone(), wk0.clone()
    for t in range(20):
        K.collide_stream(fk, buf, cc, vs_k, t, t, wk=wk_k)
        fk, buf = buf, fk
        f, vs_p[t], wk_p, terms_p, q_p = K.step_wk_plain(f, cc, t, wk_p, q_p)
        w, rho = K.windkessel_flux_plain(g, cc, wk_g)
        g, _ = K.step_plain(g, cc, t, rho_wk=rho)
        wk_g = w
    torch.cuda.synchronize()
    tag = "+bf16" if dtype == torch.bfloat16 else ""
    inst = K.instance(cc)
    assert K.launches == {
        f"lbm_collide_stream[{inst}+wk{tag}]": 20,
        "lbm_windkessel_flux" + ("[bf16]" if tag else ""): 1}
    torch.testing.assert_close(fk.float(), f.float(), rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(wk_k, wk_p, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)
    if cc.closure is None:
        assert torch.equal(fk, f) and torch.equal(wk_k, wk_p)
        assert torch.equal(stage.q, q_p) and torch.equal(stage.terms, terms_p)
        assert torch.equal(f, g) and torch.equal(wk_p, wk_g)


@pytest.mark.parametrize("how", ["set_f_standard", "direct"])
def test_windkessel_fold_primes_on_the_card(device, how):
    """The fold primes from a state it did not write: a run whose state
    is loaded mid-way equals an uninterrupted one, and two states stepped
    call by call through one case each equal their own plain sequence."""
    name, kw = WK_CASES["coronary"]
    spec = get_case(name, **kw)
    if how == "set_f_standard":
        fresh = Simulation(spec, device=device)
        fresh.run(max_steps=16, time_save=8, verbose=False)
        a = Simulation(spec, device=device)
        a.run(max_steps=8, time_save=8, verbose=False)
        b = Simulation(spec, device=device)
        b.run(max_steps=3, time_save=3, verbose=False)
        b.set_f_standard(a.f_standard())
        b.wk, b.t = a.wk.clone(), a.t
        b.run(max_steps=8, time_save=8, verbose=False)
        assert torch.equal(b.f, fresh.f) and torch.equal(b.wk, fresh.wk)
        return
    from lbm_tpu_torch.engine.compile import wk_init

    cc = compile_case(spec, device)
    w0 = torch.from_numpy(wk_init(cc.bcs)).to(device)
    starts = [initial_f(cc), initial_f(cc) * 1.001]
    runs = [[s.clone(), s.clone(), w0.clone()] for s in starts]
    series = torch.zeros(1, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(6):
        for r in runs:
            K.collide_stream(r[0], r[1], cc, series, 0, t, wk=r[2])
            r[0], r[1] = r[1], r[0]
    assert K.launches["lbm_windkessel_flux"] == 12
    for r, g in zip(runs, starts):
        wk = w0.clone()
        for t in range(6):
            wk, rho = K.windkessel_flux_plain(g, cc, wk)
            g, _ = K.step_plain(g, cc, t, rho_wk=rho)
        assert torch.equal(r[0], g) and torch.equal(r[2], wk)


def test_windkessel_simulation_on_the_card(device):
    """Simulation runs a windkessel case on the card with sim.wk on the
    device through its chunks, equal to the same run on the CPU's plain
    versions; stress, WSS and the accumulator run there."""
    name, kw = WK_CASES["coronary"]
    spec = get_case(name, **kw)
    a = Simulation(spec, device=device)
    b = Simulation(spec, device="cpu")
    for s in (a, b):
        s.run(max_steps=30, time_save=10, verbose=False)
    assert a.wk.device == device
    torch.testing.assert_close(a.f.cpu(), b.f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(a.wk.cpu(), b.wk, rtol=1e-6, atol=1e-12)
    w = a.wss()
    assert w.device == device and float(w.max()) > 0
    acc = a.wss_accumulator()
    acc.sample_sim(a)
    assert torch.isfinite(acc.tawss_field()).all()


def test_sparse_backend_matches_the_kernel_backend(device):
    """The live-cell backend (torch ops on the card) against the kernel
    backend on the small coronary, 60 steps across the series phases: f
    at fluid cells at rtol 3e-6 / atol 1e-7, velsum at 1e-5 relative,
    macro() alike."""
    spec = get_case("coronary", shape=(64, 48, 96), radius=4,
                    pulsatile=(4, 8))
    a = Simulation(spec, device=device, backend="sparse")
    b = Simulation(spec, device=device)
    vs_a = [a._advance(20) for _ in range(3)]
    vs_b = [b._advance(20) for _ in range(3)]
    fl = b.cc.fluid
    torch.testing.assert_close(a.f_standard()[:, fl], b.f[:, fl],
                               rtol=3e-6, atol=1e-7)
    for x, y in zip(vs_a, vs_b):
        assert abs(x - y).max() <= 1e-5 * abs(y).min()
    torch.testing.assert_close(a.macro()[1][:, fl], b.macro()[1][:, fl],
                               rtol=3e-5, atol=5e-7)


def test_dense_bouzidi_on_the_card_matches_the_cpu(device):
    """The dense step with curved walls (and RCR outlets) on the card
    against the same run on the CPU, 30 steps; the sparse backend on the
    card too."""
    spec = get_case("coronary", shape=(48, 24, 40), radius=5, curved=True,
                    pulsatile=(4, 8),
                    windkessel=[(1e-4, 5e3, 2e-3)] * 4)
    runs = [Simulation(spec, device=d, backend=be)
            for d, be in ((device, "dense"), ("cpu", "dense"),
                          (device, "sparse"))]
    for s in runs:
        s.run(max_steps=30, time_save=10, verbose=False)
    ref = runs[1]
    fl = ref.cc.fluid
    for s in (runs[0], runs[2]):
        torch.testing.assert_close(s.f_standard().cpu()[:, fl],
                                   ref.f[:, fl], rtol=3e-6, atol=1e-7)
        torch.testing.assert_close(s.wk.cpu(), ref.wk, rtol=3e-5,
                                   atol=1e-8)


def test_live_cell_wss_route_matches_the_dense_route(device, monkeypatch):
    """The kernel backend's live-cell WSS route (the live cells gathered
    out of the card's state) against its dense pull, on the small
    coronary with RCR outlets 40 steps in; the same per-cell arithmetic,
    so equal, and the accumulator with it."""
    spec = get_case("coronary", shape=(64, 48, 96), radius=4,
                    pulsatile=(4, 8), windkessel=[(1e-4, 5e3, 2e-3)] * 4)
    sim = Simulation(spec, device=device)
    sim.run(max_steps=40, time_save=20, verbose=False)
    dense = sim.wss()
    monkeypatch.setattr(Simulation, "_wss_via_sparse", lambda self: True)
    live = sim.wss()
    assert live.device == device and float(live.max()) > 0
    torch.testing.assert_close(live, dense, rtol=1e-6, atol=1e-12)
    acc = sim.wss_accumulator()
    acc.sample_sim(sim)
    torch.testing.assert_close(acc.tawss_field(), dense, rtol=1e-6,
                               atol=1e-12)


def _periodic_box(shape, tau=1.0, force=None):
    import numpy as np

    from lbm_tpu_torch.core.units import UnitSystem
    from lbm_tpu_torch.engine.spec import CaseSpec
    from lbm_tpu_torch.geometry.mask import CellType

    return CaseSpec(name="box", shape=shape, tau=tau,
                    units=UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0),
                    mask=np.full(shape, int(CellType.FLUID), np.int32),
                    boundaries=[], force=force)


def test_adjoint_gradient_on_the_card_matches_the_cpu(device):
    """d P_c(final) / d log Rd through a 60-step rollout of poiseuille n=12
    with a windkessel outlet, on the card against the CPU port: value and
    gradient at rtol 1e-4 (the card's sums and divisions round apart from
    the CPU's in the last bits, over 60 steps and their adjoint)."""
    from lbm_tpu_torch.engine import adjoint

    spec = get_case("poiseuille", n=12, windkessel=(5e-4, 24000.0, 2.5e-3))
    out = []
    for dev in (device, torch.device("cpu")):
        cc = compile_case(spec, dev)
        base = torch.from_numpy(adjoint.wk_params(cc)).to(dev)
        x = torch.log(base[0, 2]).requires_grad_(True)
        theta = torch.cat([base[:, :2], torch.exp(x).reshape(1, 1)], 1)
        loss = adjoint.rollout(cc, theta, 60, remat_chunk=20)[1][0]
        (g,) = torch.autograd.grad(loss, x)
        out.append((float(loss), float(g)))
    (lc, gc), (lp, gp) = out
    assert gp != 0.0
    assert abs(lc - lp) <= 1e-4 * abs(lp) and abs(gc - gp) <= 1e-4 * abs(gp)


@pytest.mark.parametrize("name", ["ShanChen", "BinaryFluid", "IBMFlow"])
def test_multiphase_and_ibm_steps_on_the_card_match_the_cpu(device, name):
    """One eager step and 20 CUDA-graph steps (IBMFlow: 20 eager) on the
    card against the CPU from the same seeded state: rtol 1e-5 / atol 1e-7
    (exp rounds apart on the card; IBM's index_add_ adds in no fixed order
    there)."""
    import numpy as np

    from lbm_tpu_torch.engine.binary import BinaryFluid
    from lbm_tpu_torch.engine.ibm import IBMFlow, marker_plane
    from lbm_tpu_torch.engine.multiphase import ShanChen

    shape = (16, 12, 20)
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(shape).astype(np.float32)

    def make(dev):
        if name == "ShanChen":
            return ShanChen(_periodic_box(shape), G=-5.0,
                            rho_init=np.log(2.0) * (1 + 0.01 * noise),
                            device=dev)
        if name == "BinaryFluid":
            return BinaryFluid(_periodic_box(shape, tau=0.8), A=0.002,
                               kappa=0.008, phi_init=np.tanh(noise),
                               device=dev)
        plates = np.concatenate([marker_plane(3.0, 2, shape),
                                 marker_plane(15.5, 2, shape)])
        return IBMFlow(_periodic_box(shape, force=(1e-5, 0.0, 0.0)), plates,
                       device=dev)

    card, cpu = make(device), make("cpu")
    for n in (1, 20):
        card.run(n)
        cpu.run(n)
        torch.testing.assert_close(card.f.cpu(), cpu.f, rtol=1e-5, atol=1e-7)
        if name == "BinaryFluid":
            torch.testing.assert_close(card.g.cpu(), cpu.g, rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("name", ["ShanChen", "BinaryFluid"])
def test_step_graph_replays_the_eager_step(device, name):
    """engine/graph.StepGraph: 30 graph replays equal 30 eager steps bit
    for bit (the same kernels in the same order)."""
    import numpy as np

    from lbm_tpu_torch.engine.binary import BinaryFluid
    from lbm_tpu_torch.engine.multiphase import ShanChen

    shape = (20, 16, 12)
    noise = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    runs = []
    for graph in (False, True):
        if name == "ShanChen":
            obj = ShanChen(_periodic_box(shape), G=-5.0,
                           rho_init=np.log(2.0) * (1 + 0.01 * noise),
                           device=device, graph=graph)
        else:
            obj = BinaryFluid(_periodic_box(shape, tau=0.8), A=0.002,
                              kappa=0.008, phi_init=np.tanh(noise),
                              device=device, graph=graph)
        obj.run(10)
        obj.run(20)
        runs.append(obj)
    assert runs[0].t == runs[1].t == 30
    assert torch.equal(runs[0].f, runs[1].f)
    if name == "BinaryFluid":
        assert torch.equal(runs[0].g, runs[1].g)


def test_adjoint_graph_route_equals_the_eager_route(device):
    """engine/adjoint.rollout on the card: the CUDA-graph route's 60-step
    state equals the eager route's bit for bit, and its d P_c / d log Rd
    (a chunk's graphed backward) the eager autograd's at rtol 1e-6."""
    from lbm_tpu_torch.engine import adjoint

    cc = compile_case(get_case("poiseuille", n=12,
                               windkessel=(5e-4, 24000.0, 2.5e-3)), device)
    out = []
    for graph in (False, None):
        base = torch.from_numpy(adjoint.wk_params(cc)).to(device)
        x = torch.log(base[0, 2]).requires_grad_(True)
        theta = torch.cat([base[:, :2], torch.exp(x).reshape(1, 1)], 1)
        f, wk = adjoint.rollout(cc, theta, 60, remat_chunk=20, graph=graph)
        (g,) = torch.autograd.grad(wk[0], x)
        out.append((f.detach(), wk.detach(), float(g)))
    (fe, wke, ge), (fg, wkg, gg) = out
    assert torch.equal(fe, fg) and torch.equal(wke, wkg)
    assert ge != 0.0 and abs(gg - ge) <= 1e-6 * abs(ge)


def _bifurcation_spec(tmp_path):
    """The bifurcation case on chip_smoke's synthetic geo.txt and bc.txt
    (the reference's files are not in the repository)."""
    import chip_smoke

    files = chip_smoke.bifurcation_inputs(str(tmp_path), surface=False)
    return get_case("bifurcation", geo_path=files["geo"],
                    bc_path=files["bc"])


def test_bifurcation_kernel_step_matches_plain(device, tmp_path):
    """The bifurcation (a field inlet with rho extrapolated at y=1, rho* =
    1 with u extrapolated at y=ny-2) on the list K1 against step_plain
    over 20 steps, f at rtol 3e-6 / atol 1e-7 and velsum at 1e-5, each a
    launch under its literal counter."""
    cc = compile_case(_bifurcation_spec(tmp_path), device)
    assert K.counter_name(cc) == "lbm_collide_stream_list[bgk]"
    f = initial_f(cc)
    fk, buf = f.clone(), f.clone()
    vs_k = torch.zeros(20, dtype=torch.float64, device=device)
    vs_p = torch.zeros(20, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(20):
        K.step(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        f, vs_p[t] = K.step_plain(f, cc, t)
    torch.cuda.synchronize()
    assert K.launches["lbm_collide_stream_list[bgk]"] == 20
    torch.testing.assert_close(fk, f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)


def test_bifurcation_macro_on_the_card_matches_plain(device, tmp_path):
    """Simulation(bifurcation).macro() after 40 kernel steps: one K3
    launch, equal to the same state's plain moments (K3 at rtol 1e-6 /
    atol 1e-7) with the non-fluid cells' initial values."""
    from lbm_tpu_torch.engine.step import init_override

    sim = Simulation(_bifurcation_spec(tmp_path), device=device)
    sim.run(max_steps=40, time_save=20, verbose=False)
    K.reset_launches()
    rho, u = sim.macro()
    assert K.launches["lbm_macro"] == 1
    rho_p, u_p = init_override(sim.cc, *K.macro_plain(sim.f, sim.cc.force))
    torch.testing.assert_close(rho, rho_p, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(u, u_p, rtol=1e-6, atol=1e-7)
    assert torch.isfinite(u).all() and float(u.abs().max()) < 0.15


def test_demo_512_outputs_stages_on_the_card(device, tmp_path):
    """demo_512_outputs' stages at n=64 with lowmem forced, on the card and
    on the CPU (the plain versions): the first chunk's velsums, |u|max and
    the WSS cells' count, mean and max at 1e-5 relative; on the card the
    checkpoint (K4's chunked read) restored into a fresh Simulation and
    stepped 2 steps, bit-equal to the original run stepped the same
    steps."""
    import numpy as np

    from lbm_tpu_torch.tools import coronary_cube
    from lbm_tpu_torch.tools import demo_512_outputs as D

    spec = coronary_cube(64)
    got = {}
    for dev in (device, torch.device("cpu")):
        sim = D.make_sim(spec, dev, True)
        vs, _ = D.chunk(sim, 4)
        D.chunk(sim, 4)
        got[dev.type] = (vs, D.u_max(sim), D.wss_stats(sim))
        if dev.type != "cuda":
            continue
        path = str(tmp_path / "demo512.ckpt.npz")
        K.reset_launches()
        D.write_checkpoint(sim, path)
        assert K.launches == {"lbm_extract_rows": -(-64 // K.chunk_rows(
            spec.shape))}
        sim2, _ = D.restore_sim(spec, path, device, True)
        r2, _ = D.chunk(sim2, 2)
        r1, _ = D.chunk(sim, 2)
        assert sim2.t == sim.t == 10
        assert torch.equal(sim.f, sim2.f) and np.array_equal(r1, r2)
    (vs_k, u_k, w_k), (vs_p, u_p, w_p) = got["cuda"], got["cpu"]
    np.testing.assert_allclose(vs_k, vs_p, rtol=1e-5)
    np.testing.assert_allclose(u_k, u_p, rtol=1e-5)
    assert w_k["count"] == w_p["count"] > 0
    np.testing.assert_allclose([w_k["mean_pa"], w_k["max_pa"]],
                               [w_p["mean_pa"], w_p["max_pa"]], rtol=1e-5)


def test_demo_512_sharded_on_two_card_ranks(device, tmp_path):
    """demo_512_sharded at n=64 on 2 gloo ranks sharing the card: each
    step's velsum against the unsharded card run at 1e-5 relative, K1d
    over each rank's fluid cells once a step, every window finite with
    zeros at DEAD cells, and each window's first and last y rows bit-equal
    to the unsharded state's (zeros at DEAD cells)."""
    import numpy as np

    from lbm_tpu_torch.geometry.mask import CellType
    from lbm_tpu_torch.tools import coronary_cube
    from lbm_tpu_torch.tools import demo_512_sharded as S

    spec = coronary_cube(64)
    spec_dir = tmp_path / "spec"
    spec_dir.mkdir()
    S.save_spec(spec, str(spec_dir))
    ranks = S.run_sharded(str(spec_dir), 2, 2, "cuda", timeout=300,
                          rows_dir=str(tmp_path))
    out = S.report(ranks, 64, 2)
    assert out["launches"] == [{"lbm_collide_stream_list[bgk+halo]": 2}] * 2
    sim = Simulation(spec, device=device)
    res = sim.run(max_steps=2, time_save=2, verbose=False)
    np.testing.assert_allclose(
        out["velsum"], res.velsum_series - sim.case.velsum_offset, rtol=1e-5)
    dead = sim.cc.mask == CellType.DEAD
    for r in range(2):
        rows = np.load(S.window_rows_path(str(tmp_path), r))
        for k, y in enumerate((32 * r, 32 * r + 31)):
            want = torch.where(dead[:, y], 0.0, sim.f[:, :, y]).cpu()
            assert torch.equal(torch.from_numpy(rows[k]), want), (r, y)
