#!/usr/bin/env python3
"""P_c and the staged flux Q of the windkessel cases of the card tests
(tests/test_torch_cuda.py WK_CASES) after N steps from rest, in float32
and bfloat16 storage, stepped in lbm_tpu's order (a flux from each
pre-step state, then the step: windkessel_flux_plain and step_plain, the
fold's plain versions, bit for bit the kernels' on the card). Shows which
states hold Q = 0 at an outlet (a bf16 state rounds a small flow away).

    python3 probes/wk_states.py [STEPS ...]   # default 20 80; on the CPU
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from lbm_tpu_torch.cases import get_case  # noqa: E402
from lbm_tpu_torch.engine.compile import compile_case, wk_init  # noqa: E402
from lbm_tpu_torch.engine.step import initial_f  # noqa: E402
from lbm_tpu_torch.kernels import collide_stream as K  # noqa: E402

WK4 = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3), (1e-4, 5e3, 4e-3),
       (1e-4, 5e3, 8e-3)]
CASES = {
    "coronary": ("coronary", dict(shape=(48, 24, 40), radius=5,
                                  windkessel=WK4, pulsatile=(4, 8))),
    "coronary+trt+cy": ("coronary", dict(
        shape=(48, 24, 40), radius=5, windkessel=WK4, collision="trt",
        rheology={"model": "carreau", "nu0": 0.05, "nu_inf": 0.005,
                  "lam": 10.0, "n": 0.5})),
    "poiseuille": ("poiseuille", dict(n=16,
                                      windkessel=(5e-4, 24000.0, 2.5e-3))),
}


def main() -> int:
    marks = sorted(int(a) for a in sys.argv[1:]) or [20, 80]
    for label, (name, kw) in CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            cc = compile_case(get_case(name, **kw))
            f = initial_f(cc).to(dtype)
            w = torch.from_numpy(wk_init(cc.bcs))
            for t in range(marks[-1]):
                w, rho = K.windkessel_flux_plain(f, cc, w)
                f, _ = K.step_plain(f, cc, t, rho_wk=rho)
                if t + 1 in marks:
                    q = K.wk_terms_plain(f, cc)[1]
                    print(f"{label} {str(dtype)[6:]} after {t + 1} steps: "
                          f"P_c {w.tolist()}, Q {q.tolist()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
