#!/usr/bin/env python3
"""How far bf16 storage drifts from fp32 on the lid cavity, on the CPU, in
both packages: lbm_tpu (its Pallas backend, store_dtype f32 and bf16, in
interpret mode) and the port (the kernel backend's plain versions, f32
and bf16), each lid_driven_cavity n for 1000 steps. Prints, per n and
package, u's relative L2 of the bf16 run against the fp32 run over the
driven rows below the lid and over the resting bulk beneath them
(chip_smoke.lid_drift_split), beside the whole box's, and how far the two
packages' fp32 runs and their bf16 runs differ from each other.

    python3 probes/bf16_drift.py [N ...]   # default 32 48; CPU only

Prints one JSON object. lbm_tpu's bf16 storage (its design) is what
drifts; no bound of either package depends on this measurement.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
STEPS = 1000


def lbm_tpu_u(n: int, dtype: str) -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from lbm_tpu.cases import get_case
    from lbm_tpu.engine.runner import Simulation

    sim = Simulation(get_case("lid_driven_cavity", n=n), backend="pallas",
                     store_dtype=dtype)
    sim.run(max_steps=STEPS, time_save=STEPS, verbose=False)
    return np.asarray(sim.macro()[1], np.float32)


def port_u(n: int, dtype: str) -> np.ndarray:
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation

    sim = Simulation(get_case("lid_driven_cavity", n=n), device="cpu",
                     store_dtype=dtype)
    sim.run(max_steps=STEPS, time_save=STEPS, verbose=False)
    return sim.macro()[1].numpy()


def main() -> int:
    import torch

    import chip_smoke as C
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.geometry.mask import CellType

    sizes = [int(a) for a in sys.argv[1:]] or [32, 48]
    out = {"steps": STEPS}
    for n in sizes:
        fluid = torch.from_numpy(np.asarray(
            get_case("lid_driven_cavity", n=n).mask) == CellType.FLUID)
        row = {}
        runs = {}
        for pkg, run in (("lbm_tpu", lbm_tpu_u), ("port", port_u)):
            u32 = torch.from_numpy(run(n, "f32").copy())
            u16 = torch.from_numpy(run(n, "bf16").copy())
            runs[pkg] = (u32, u16)
            driven, bulk = C.lid_drift_split(u16, u32, fluid)
            row[pkg] = {"whole": C.rel_l2(u16[:, fluid], u32[:, fluid]),
                        "driven rows": driven, "resting bulk": bulk}
        for k, name in enumerate(("fp32", "bf16")):
            row[f"{name} port against lbm_tpu, max abs"] = float(
                (runs["port"][k] - runs["lbm_tpu"][k]).abs().max())
        out[f"lid {n}^3"] = row
        print(f"lid {n}^3", json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
