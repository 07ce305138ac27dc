"""The kernel route's plain versions on the collision branches, held
against lbm_tpu's Pallas kernel in interpret mode: the body force, MRT,
the moving lid, and TRT + the Carreau blood closure on a pulsatile
coronary, whose z-plane sub-outlets go through the fixup's plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine import step as ref_step
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.kernels.collide_stream import (
    make_pallas_step,
    pack_state,
    pad_spec,
    unpack_state,
)
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.core.rheology import carreau_blood
from lbm_tpu_torch.engine.compile import compile_case
from lbm_tpu_torch.engine.step import initial_f
from lbm_tpu_torch.kernels import collide_stream as K

CORONARY = dict(shape=(32, 24, 48), radius=4, pulsatile=(4, 8))

# (case, options, steps); the coronary gains its blood closure below.
# The channel's force is 1000x its default, so that |u| reaches the lid's
# ~0.05 in six steps: at a slow |u| the momentum sums lose their leading
# digits to cancellation, and one-ulp differences in f (the two kernels
# round differently) move the velsum by more than 1e-5.
COMPOSITIONS = {
    "gravity_channel bgk+force": ("gravity_channel",
                                  dict(n=16, nz=16, fz=1e-2), 6),
    "lid mrt": ("lid_driven_cavity", dict(n=16, collision="mrt"), 6),
    "lid moving wall": ("lid_driven_cavity", dict(n=16, lid="bounceback"), 6),
    "coronary trt+carreau": ("coronary", dict(CORONARY, collision="trt"), 6),
}


def _options(name, kw):
    """The case options, the coronary's with the Carreau blood closure at
    its units (a plain dict, equal in both packages)."""
    if name != "coronary":
        return kw
    units = get_case("coronary", **dict(kw, collision="bgk")).units
    return dict(kw, rheology=carreau_blood(units))


@pytest.mark.parametrize("which", sorted(COMPOSITIONS))
def test_kernel_route_matches_pallas(which):
    """step_plain (the collide-stream kernel's plain version, then the
    z-plane fixups') against make_pallas_step(interpret=True) on the
    padded case: f at rtol 3e-6 / atol 1e-7 and the per-step velsum at
    rtol 1e-5, as tests/test_torch_vessel.py holds the BGK path."""
    name, kw, steps = COMPOSITIONS[which]
    spec_pad = pad_spec(ref_get_case(name, **_options(name, kw)))
    cc_pad = ref_compile_case(spec_pad)
    pstep = jax.jit(make_pallas_step(cc_pad, interpret=True))
    p = pack_state(ref_step.initial_f(cc_pad),
                   jnp.asarray(np.asarray(spec_pad.mask)))
    vs_ref = []
    for t in range(steps):
        p, v = pstep(p, jnp.int32(t))
        vs_ref.append(float(np.asarray(v).sum()))
    f_ref = np.asarray(unpack_state(p))[:, 1:-1, 1:-1, :]

    cc = compile_case(get_case(name, **_options(name, kw)))
    f = initial_f(cc)
    vs = torch.zeros(steps, dtype=torch.float64)
    for t in range(steps):
        f, vs[t] = K.step_plain(f, cc, t)
    assert float((f - initial_f(cc)).abs().max()) > 1e-5
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(vs.numpy(), vs_ref, rtol=1e-5)
    if name == "coronary":
        assert len(cc.z_bcs) == 3 and K.instance(cc) == "trt+cy"
