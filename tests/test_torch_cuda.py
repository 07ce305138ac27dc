"""The CUDA kernels held against their plain versions on a CUDA card.

Marked `cuda`; each test skips without a card. The file imports neither
jax nor lbm_tpu, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import pytest
import torch

from lbm_tpu_torch.cases import get_case
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
        K.collide_stream(fk, buf, cc, vs_k, t)
        fk, buf = buf, fk
        f, vs_p[t] = K.collide_stream_plain(f, cc)
    torch.cuda.synchronize()
    assert K.launches["lbm_collide_stream_bgk"] == 4
    torch.testing.assert_close(fk, f, rtol=3e-6, atol=1e-7)
    torch.testing.assert_close(vs_k, vs_p, rtol=1e-5, atol=0.0)


def test_macro_kernel_matches_plain(device):
    cc = compile_case(get_case("poiseuille", n=24), device)
    f = initial_f(cc)
    f, _ = K.collide_stream_plain(f, cc)
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
