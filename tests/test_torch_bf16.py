"""bf16 storage of the flow state (Simulation(store_dtype='bf16')) held
against lbm_tpu's bf16 Pallas path on the CPU: its make_pallas_step on a
bf16 pack_state in interpret mode, its fuse=2 runner, its bounds against
the fp32 dense step and on mass; the plain versions' one rounding place;
the refusals, dtypes, the chunked read and the CLI."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine import step as ref_step
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.kernels.collide_stream import (
    make_pallas_step,
    pack_state,
    pad_spec,
    unpack_state,
)
from lbm_tpu_torch import bridge
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.step import initial_f
from lbm_tpu_torch.kernels import collide_stream as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COR = dict(shape=(24, 20, 32), radius=4)
BF16 = torch.bfloat16


def _pallas_bf16(name, kw, steps):
    """lbm_tpu's Pallas step (interpret mode) on a bf16 pack_state of the
    padded case: the unpadded interior of f (widened) after `steps`
    steps and the per-step velsums."""
    spec_pad = pad_spec(ref_get_case(name, **kw))
    cc_pad = ref_compile_case(spec_pad)
    step = jax.jit(make_pallas_step(cc_pad, interpret=True))
    p = pack_state(ref_step.initial_f(cc_pad),
                   jnp.asarray(np.asarray(spec_pad.mask)), dtype=jnp.bfloat16)
    assert p.dtype == jnp.bfloat16
    vs = []
    for t in range(steps):
        p, v = step(p, jnp.int32(t))
        vs.append(float(np.asarray(v).sum()))
    f = np.asarray(unpack_state(p))[:, 1:-1, 1:-1, :]
    return np.ascontiguousarray(f), np.asarray(vs)


def _port_steps(cc, steps):
    """`steps` steps of the kernel path's wrappers (their plain versions
    on the CPU) from the bf16 initial state: (f, per-step velsums)."""
    f = initial_f(cc).to(BF16)
    out = f.clone()
    series = torch.zeros(steps, dtype=torch.float64)
    for k in range(steps):
        K.step(f, out, cc, series, k, k)
        f, out = out, f
    return f, series


def test_coronary_bit_equal_to_lbm_tpu_bf16_kernel():
    """Coronary (24, 20, 32) r=4 with its three z-plane sub-outlets, 4
    steps: the bf16 Simulation's f bit for bit lbm_tpu's bf16 Pallas
    state (interior, z planes included), the step wrappers' too, and the
    velsums at 1e-5 relative."""
    f_ref, vs_ref = _pallas_bf16("coronary", COR, 4)
    sim = Simulation(get_case("coronary", **COR), device="cpu",
                     store_dtype="bf16")
    assert len(sim.cc.z_bcs) == 3
    sim.run(max_steps=4, time_save=2, verbose=False)
    assert sim.f.dtype == BF16
    np.testing.assert_array_equal(sim.f_standard().numpy(), f_ref)
    f, series = _port_steps(sim.cc, 4)
    assert torch.equal(f, sim.f)
    np.testing.assert_allclose(series.numpy(), vs_ref, rtol=1e-5)


# (case, options) of the collision branches, 2 steps each; the channel's
# force is 100x its default so that |u| moves within two steps
BRANCHES = {
    "lid trt": ("lid_driven_cavity", dict(n=16, collision="trt")),
    "lid mrt": ("lid_driven_cavity", dict(n=16, collision="mrt")),
    "lid moving wall": ("lid_driven_cavity", dict(n=16, lid="bounceback")),
    "gravity_channel trt+force": ("gravity_channel", dict(
        n=16, nz=16, collision="trt", fz=1e-3)),
}


@pytest.mark.parametrize("which", sorted(BRANCHES))
def test_branch_bit_equal_to_lbm_tpu_bf16_kernel(which):
    """Each branch's bf16 plain versions against lbm_tpu's bf16 kernel,
    2 steps: f bit for bit, velsums at 1e-5 relative."""
    name, kw = BRANCHES[which]
    f_ref, vs_ref = _pallas_bf16(name, kw, 2)
    cc = compile_case(get_case(name, **kw))
    f, series = _port_steps(cc, 2)
    assert float((f.float() - initial_f(cc)).abs().max()) > 1e-5
    np.testing.assert_array_equal(f.float().numpy(), f_ref)
    np.testing.assert_allclose(series.numpy(), vs_ref, rtol=1e-5)


def test_fuse2_bit_equal_to_lbm_tpu_bf16_fuse2_and_rounds_once_a_pair():
    """lid n=16 fuse=2 in bf16, 2 pairs in one chunk, against lbm_tpu's
    bf16 fuse=2 Pallas runner (ring 2, fp32 mid tile): bit for bit. The
    port's bf16 fuse=1 run narrows between the two steps and differs."""
    kw = dict(n=16, max_steps=4, time_save=4)
    ref = RefSimulation(ref_get_case("lid_driven_cavity", **kw),
                        backend="pallas", fuse=2, store_dtype="bf16")
    assert ref._fuse2
    r_ref = ref.run(verbose=False)
    spec = get_case("lid_driven_cavity", **kw)
    sim = Simulation(spec, device="cpu", fuse=2, store_dtype="bf16")
    res = sim.run(verbose=False)
    assert res.steps == r_ref.steps == 4
    np.testing.assert_array_equal(sim.f_standard().numpy(),
                                  np.asarray(ref.f_standard()))
    assert abs(res.residual - r_ref.residual) < 1e-6
    one = Simulation(spec, device="cpu", store_dtype="bf16")
    one.run(verbose=False)
    assert not torch.equal(one.f, sim.f)


def test_plain_versions_round_once_a_step_and_once_a_pair():
    """step_plain on bf16 is "widen, the fp32 step, narrow" (the z-plane
    fixups included) and collide_stream2_plain "widen, two fp32 steps,
    narrow", bit for bit, with the fp32 velsums; step2 on the CPU writes
    both."""
    cc = compile_case(get_case("coronary", **COR, pulsatile=(4, 8)))
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.uniform(0.02, 0.06, (19,) + cc.shape)
                         .astype(np.float32)).to(BF16)
    t = 5
    want, v_want = K.step_plain(f.float(), cc, t)
    got, v_got = K.step_plain(f, cc, t)
    assert got.dtype == BF16 and torch.equal(got, want.to(BF16))
    assert float(v_got) == float(v_want)
    lid = compile_case(get_case("lid_driven_cavity", n=12))
    g = torch.from_numpy(rng.uniform(0.02, 0.06, (19,) + lid.shape)
                         .astype(np.float32)).to(BF16)
    g1, w1 = K.collide_stream_plain(g.float(), lid, t)
    g2, w2 = K.collide_stream_plain(g1, lid, t + 1)
    pair, u1, u2 = K.collide_stream2_plain(g, lid, t)
    assert pair.dtype == BF16 and torch.equal(pair, g2.to(BF16))
    assert (float(u1), float(u2)) == (float(w1), float(w2))
    out = torch.empty_like(g)
    series = torch.zeros(2, dtype=torch.float64)
    K.step2(g, out, lid, series, 0, t)
    assert torch.equal(out, pair)
    assert series.tolist() == [float(w1), float(w2)]
    rho, u = K.macro(g)
    rho_w, u_w = K.macro_plain(g.float())
    assert rho.dtype == u.dtype == torch.float32
    assert torch.equal(rho, rho_w) and torch.equal(u, u_w)


def test_bounds_of_lbm_tpu_bf16_against_fp32_and_on_mass():
    """lbm_tpu's own bf16 bounds: the coronary within 2e-2 of max |f| of
    its fp32 dense step after 2 steps; the closed n=16 box's mass drift
    under 5e-3 over 16 steps."""
    ref_cc = ref_compile_case(ref_get_case("coronary", **COR))
    f_ref = ref_step.initial_f(ref_cc)
    step = jax.jit(ref_step.make_step(ref_cc))
    for t in range(2):
        f_ref = step(f_ref, jnp.int32(t))[0]
    f_ref = np.asarray(f_ref)
    sim = Simulation(get_case("coronary", **COR), device="cpu",
                     store_dtype="bf16")
    sim.run(max_steps=2, time_save=2, verbose=False)
    f = sim.f_standard().numpy()
    rel = np.abs(f - f_ref).max() / np.abs(f_ref).max()
    assert 0 < rel < 2e-2, rel

    case = get_case("lid_driven_cavity", n=16, u_lid_phys=0.0,
                    max_steps=16, time_save=16)
    box = Simulation(case, device="cpu", store_dtype="bf16")
    fluid = torch.from_numpy(np.asarray(case.mask) == 4)
    m0 = float(box.f_standard().sum(0)[fluid].double().sum())
    box.run(verbose=False)
    m1 = float(box.f_standard().sum(0)[fluid].double().sum())
    assert abs(m1 - m0) / m0 < 5e-3


@pytest.mark.parametrize("kw,match", [
    (dict(backend="dense", store_dtype="bf16"),
     "store_dtype='bf16' is a packed-Pallas-state feature; the dense/sparse "
     "backends keep fp32 state"),
    (dict(store_dtype="fp16"), "store_dtype must be f32 or bf16, got fp16"),
])
def test_refusals_in_lbm_tpus_words(kw, match):
    with pytest.raises(ValueError, match=match.replace("(", r"\(")):
        Simulation(get_case("lid_driven_cavity", n=8), device="cpu", **kw)


@pytest.mark.parametrize("name", [None, "f32", "fp32", "float32", "bf16",
                                  "bfloat16"])
def test_store_dtype_names(name):
    sim = Simulation(get_case("lid_driven_cavity", n=8), device="cpu",
                     store_dtype=name)
    want = BF16 if name in ("bf16", "bfloat16") else torch.float32
    assert sim.f.dtype == sim._spare.dtype == want


def test_state_dtypes_and_accessors():
    """f and the spare buffer are bf16 (the fp32 feq narrowed);
    f_standard() widens, set_f_standard() narrows, macro() is fp32 from
    widened loads; the velsum offset stays the fp32 constant."""
    spec = get_case("coronary", **COR)
    sim = Simulation(spec, device="cpu", store_dtype="bf16")
    ref = Simulation(spec, device="cpu")
    assert sim.f.dtype == sim._spare.dtype == BF16 and sim.f.is_contiguous()
    assert torch.equal(sim.f, ref.f.to(BF16))
    assert sim.cc.velsum_offset == ref.cc.velsum_offset
    std = sim.f_standard()
    assert std.dtype == torch.float32 and torch.equal(std, sim.f.float())
    rng = np.random.default_rng(5)
    new = rng.uniform(0.02, 0.06, (19,) + spec.shape).astype(np.float32)
    sim.set_f_standard(new)
    want = torch.from_numpy(new).to(BF16)
    assert torch.equal(sim.f, want) and torch.equal(sim._spare, want)
    rho, u = sim.macro()
    ref.set_f_standard(want.float())
    rho_w, u_w = ref.macro()
    assert rho.dtype == u.dtype == torch.float32
    assert torch.equal(rho, rho_w) and torch.equal(u, u_w)


def test_force_field_refuses_bf16_state():
    cc = compile_case(get_case("lid_driven_cavity", n=8))
    f = initial_f(cc).to(BF16)
    g = torch.zeros((7,) + cc.shape)
    series = torch.zeros(1, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 state only"):
        K.collide_stream(f, f.clone(), cc, series, 0, 0,
                         field=K.ForceField((0.0, 0.0, 1e-3)), g=g)
    with pytest.raises(ValueError, match="one storage type"):
        K.collide_stream(f, f.float(), cc, series, 0, 0)


def test_chunked_read_of_a_bf16_state():
    """unpack_state_lowmem of a bf16 state is f.float() (its chunks
    extract_rows in bf16); a lowmem bf16 run's f_standard() too."""
    rng = np.random.default_rng(4)
    f = torch.from_numpy(rng.random((19, 13, 4, 3), dtype=np.float32)) \
        .to(BF16)
    chunk = K.extract_rows(f, 5, 4)
    assert chunk.dtype == BF16 and torch.equal(chunk, f[:, 5:9])
    host = K.unpack_state_lowmem(f)
    assert host.dtype == torch.float32 and torch.equal(host, f.float())
    sim = Simulation(get_case("coronary", **COR), device="cpu", lowmem=True,
                     store_dtype="bf16")
    sim.run(max_steps=2, time_save=2, verbose=False)
    got = sim.f_standard()
    assert got.data_ptr() != sim.f.data_ptr()
    assert torch.equal(got, sim.f.float())


def test_bridge_widens_bf16_words_bit_for_bit():
    """as_float32 of the |V2 void np.savez makes of bf16 words and of
    ml_dtypes bfloat16 equals torch's widening; state_from_numpy narrows
    into a bf16 state exactly."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((19, 3, 4, 5))
                         .astype(np.float32)).to(BF16)
    words = x.view(torch.int16).numpy().view(np.uint16)
    void = words.view(np.dtype("V2"))
    assert np.array_equal(bridge.as_float32(void), x.float().numpy())
    ml = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert np.array_equal(bridge.as_float32(ml), x.float().numpy())
    assert torch.equal(bridge.state_from_numpy(void, dtype=BF16), x)
    assert np.array_equal(bridge.state_to_numpy(x), x.float().numpy())


def test_cli_run_dtype_bf16(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch", "run", "--device", "cpu",
         "--case", "lid_driven_cavity", "--opt", "n=12", "--dtype", "bf16",
         "--steps", "20", "--time-save", "10", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(out)) == [
        "CONVERGENCE.log", "lid_driven_cavity_10.vtk",
        "lid_driven_cavity_20.vtk"]
