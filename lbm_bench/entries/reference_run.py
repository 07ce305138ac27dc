"""Entry: the plain reference itself in the program's place, its
populations held in a lower precision: the control of a cell whose
program has no lower-precision path of its own (the coupled kernel takes
an fp32 flow state only). Never a benchmark run's entry."""

from __future__ import annotations

import torch

from lbm_bench.reference.geometry import build as build_geometry
from lbm_bench.reference.scalar import Coupled
from lbm_bench.reference.stepper import Stepper

USQ_A_CHUNK = False
SCALAR = True


def load_kernels(device: torch.device) -> None:
    """Nothing to load: plain PyTorch."""


def make_case(case: str, params: dict):
    return build_geometry(case, params)


def build(geom, program: dict, device: torch.device):
    store = {"bf16": torch.bfloat16, "f32": torch.float32}[
        program["store_dtype"]]
    return Coupled(Stepper(geom, None, device, store), program["D"],
                   program["bolus"])


def chunk(ref, n: int) -> dict:
    return {"series": None, "residual": None, "record": ref.run(n)}


def state(ref) -> dict:
    return {"f": ref.flow.full_state(), "g": ref.full_g(), "t": ref.flow.t,
            "wk": ref.flow.wk}


def launches() -> int:
    return 0
