"""The kernel wrappers of lbm_tpu_torch/kernels/collide_stream.py on the CPU:
the plain versions of K1a (collide-stream) and K3 (moments) held against
lbm_tpu's Pallas kernels in interpret mode, the wrapper contract, and
the CUDA source's constant tables against the lattice."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.step import initial_f as ref_initial_f
from lbm_tpu.kernels.collide_stream import (
    make_pallas_step,
    pack_state,
    packed_macro,
    pad_spec,
    unpack_state,
)
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.core.lattice import D3Q19
from lbm_tpu_torch.engine.compile import MAX_BCS, compile_case
from lbm_tpu_torch.engine.step import initial_f
from lbm_tpu_torch.kernels import _build
from lbm_tpu_torch.kernels import collide_stream as K

STEPS = 4


@pytest.fixture(scope="module")
def pallas_lid16():
    """lbm_tpu's Pallas step (interpret mode) on the padded lid16 cavity:
    the unpadded f after STEPS steps, the per-step velsums, and
    packed_macro of the final state."""
    spec_pad = pad_spec(ref_get_case("lid_driven_cavity", n=16))
    cc_pad = ref_compile_case(spec_pad)
    step = jax.jit(make_pallas_step(cc_pad, interpret=True))
    p = pack_state(ref_initial_f(cc_pad), jnp.asarray(np.asarray(spec_pad.mask)))
    vs = []
    for t in range(STEPS):
        p, v = step(p, jnp.int32(t))
        vs.append(float(np.asarray(v).sum()))
    f = np.asarray(unpack_state(p))[:, 1:-1, 1:-1, :]
    rho, u = packed_macro(p, interpret=True)
    return np.ascontiguousarray(f), np.asarray(vs), np.asarray(rho), \
        np.asarray(u)


def _run_port(cc, steps):
    f = initial_f(cc)
    out = torch.empty_like(f)
    series = torch.zeros(steps, dtype=torch.float64)
    for t in range(steps):
        K.collide_stream(f, out, cc, series, t)
        f, out = out, f
    return f, series


def test_collide_stream_plain_matches_pallas_kernel(pallas_lid16):
    f_ref, vs_ref, _, _ = pallas_lid16
    cc = compile_case(get_case("lid_driven_cavity", n=16))
    f, series = _run_port(cc, STEPS)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(series.numpy(), vs_ref, rtol=1e-5)


def test_macro_plain_matches_packed_macro(pallas_lid16):
    f_ref, _, rho_ref, u_ref = pallas_lid16
    rho, u = K.macro_plain(torch.from_numpy(f_ref))
    np.testing.assert_allclose(rho.numpy(), rho_ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(u.numpy(), u_ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["lid_driven_cavity", "poiseuille"])
def test_wrapper_on_cpu_runs_the_plain_version(name):
    cc = compile_case(get_case(name, n=12))
    f0 = initial_f(cc)
    K.reset_launches()
    out = torch.empty_like(f0)
    series = torch.zeros(3, dtype=torch.float64)
    K.collide_stream(f0, out, cc, series, 1)
    f_plain, vs = K.collide_stream_plain(f0, cc)
    assert torch.equal(out, f_plain)
    assert series[1] == vs and series[0] == 0 and series[2] == 0
    rho, u = K.macro(out)
    rho_p, u_p = K.macro_plain(out)
    assert torch.equal(rho, rho_p) and torch.equal(u, u_p)
    assert K.launches == {"lbm_collide_stream_bgk": 0, "lbm_macro": 0}


def test_wrapper_rejects_bad_arguments():
    cc = compile_case(get_case("lid_driven_cavity", n=8))
    f = initial_f(cc)
    out = torch.empty_like(f)
    series = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="out must not be f"):
        K.collide_stream(f, f, cc, series, 0)
    with pytest.raises(ValueError, match="series"):
        K.collide_stream(f, out, cc, series.float(), 0)
    with pytest.raises(ValueError, match="series"):
        K.collide_stream(f, out, cc, series, 2)
    with pytest.raises(ValueError, match="float32"):
        K.collide_stream(f.double(), out, cc, series, 0)
    with pytest.raises(ValueError, match="shape"):
        K.collide_stream(f[:, :-1].contiguous(), out, cc, series, 0)
    with pytest.raises(ValueError, match=r"\(19, X, Y, Z\)"):
        K.macro(f[:18].contiguous())


def test_wrapper_has_no_fallback_off_the_cpu():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    routed to the plain version."""
    cc = compile_case(get_case("lid_driven_cavity", n=8), device="meta")
    f = torch.empty((19, 8, 8, 8), device="meta")
    series = torch.zeros(1, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.collide_stream(f, torch.empty_like(f), cc, series, 0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.macro(f)


def _cu_array(src, fn):
    body = re.search(fn + r"\(int i\) \{\s*constexpr int v\[Q\] = \{([^}]*)\}",
                     src).group(1)
    return [int(v) for v in body.split(",")]


def test_cuda_source_tables_match_the_lattice():
    src = _build.SOURCE.read_text()
    for a, fn in enumerate(("EX", "EY", "EZ")):
        assert _cu_array(src, fn) == D3Q19.E[:, a].tolist()
    assert _cu_array(src, "OPP") == D3Q19.OPP.tolist()
    assert int(re.search(r"kMaxBCs = (\d+);", src).group(1)) == MAX_BCS
    max_dirs = int(re.search(r"kMaxDirs = (\d+);", src).group(1))
    assert max_dirs == max(len(D3Q19.dirs_into(a, s))
                           for a in range(3) for s in (-1, 1))
    assert re.search(r"kBCInts = 6 \+ kMaxDirs;", src)
    assert K._BC_ROW == 6 + max_dirs
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_bc_descriptor_rows():
    """The rows the kernel reads: axis, consumer coord, lateral extent A,
    rho fixed?, u extrapolated?, ndirs, dirs."""
    cc = compile_case(get_case("poiseuille", n=12))
    ints, floats, valid, phis = K._bc_tables(cc)
    assert ints.shape == (2, 11)
    np.testing.assert_array_equal(ints[0, :6], [1, 2, 12, 0, 0, 5])
    np.testing.assert_array_equal(ints[1, :6], [1, 9, 12, 0, 0, 5])
    np.testing.assert_array_equal(ints[0, 6:], D3Q19.dirs_into(1, 1))
    np.testing.assert_array_equal(ints[1, 6:], D3Q19.dirs_into(1, -1))
    assert floats[0, 1] == np.float32(cc.bcs[0].omega)
    assert valid[0] == cc.bcs[0].valid.data_ptr()
    assert phis[1] == cc.bcs[1].phi_star.data_ptr()
