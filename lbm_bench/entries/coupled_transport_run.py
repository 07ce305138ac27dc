"""Entry: lbm_tpu_torch's CoupledTransport.run, one chunk a call: the flow
and a passive scalar stepped together (the flow kernel, then the D3Q7
kernel in the new flow state), the planes' concentrations recorded every
step and read back once a chunk. The inlet carries a bolus: c = 1 for
`on` steps of every `period`, from step `phase` on.
"""

from __future__ import annotations

import torch

from lbm_bench.entries.simulation_run import launches, load_kernels, \
    make_case

# what a chunk moves besides the steps: no moments or residual a chunk;
# the scalar's step beside the flow's
USQ_A_CHUNK = False
SCALAR = True


class Bolus:
    """c*(t) of the inlet: 1.0 for the first `on` steps of each period
    counted from `phase`, else 0.0."""

    def __init__(self, period: int, on: int, phase: int, **_):
        self.period, self.on, self.phase = int(period), int(on), int(phase)

    def __call__(self, t: int) -> float:
        return 1.0 if (int(t) - self.phase) % self.period < self.on else 0.0


def build(spec, program: dict, device: torch.device):
    from lbm_tpu_torch.engine.scalar import CoupledTransport

    bolus = program["bolus"]
    ct = CoupledTransport(spec, D=program["D"],
                          inlet_c={int(bolus["boundary"]): Bolus(**bolus)},
                          device=device, backend=program["backend"])
    ct.record = list(program["record"])
    return ct


def chunk(ct, n: int) -> dict:
    return {"series": None, "residual": None,
            "record": ct.run(n, record=ct.record)}


def state(ct) -> dict:
    return {"f": ct.f, "g": ct.g, "t": ct.t, "wk": ct.wk}


__all__ = ["load_kernels", "make_case", "build", "chunk", "state",
           "launches"]
