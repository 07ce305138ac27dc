"""Entry: lbm_tpu_torch's Simulation.run, one chunk a call.

A chunk is run(max_steps=n, time_save=n): one time_save chunk of n
steps, its velsum samples read back once (or, on a 'usq' case, the
moments and the residual once), as a user's run does it. A run's stop
rule is tested only after a whole chunk, so it cannot cut one short.
"""

from __future__ import annotations

import torch

# what a chunk moves besides the steps: on a 'usq' case its moments and
# residual; no scalar
USQ_A_CHUNK = True
SCALAR = False


def load_kernels(device: torch.device) -> None:
    """Load the CUDA kernel libraries (building them in a cold checkout)."""
    if device.type == "cuda":
        from lbm_tpu_torch.kernels._build import load_library

        load_library()


def make_case(case: str, params: dict):
    from lbm_tpu_torch.cases import get_case

    return get_case(case, **params)


def build(spec, program: dict, device: torch.device):
    from lbm_tpu_torch.engine.runner import Simulation

    return Simulation(spec, device=device, **program)


def chunk(sim, n: int) -> dict:
    res = sim.run(max_steps=n, time_save=n, verbose=False)
    return {"series": res.velsum_series, "residual": res.residual}


def state(sim) -> dict:
    """The state the judged outputs are read from: f (19, X, Y, Z), the
    step count, the RCR outlets' carried P_c (or None)."""
    return {"f": sim.f, "t": sim.t, "wk": sim.wk}


def launches() -> int:
    """Kernel launches so far, over every entry point (the program's own
    counters)."""
    from lbm_tpu_torch.kernels import collide_stream, scalar_stream

    return (sum(collide_stream.launches.values())
            + sum(scalar_stream.launches.values()))
