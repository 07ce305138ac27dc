"""Carry case specs and states across from lbm_tpu.

Both packages keep the same CaseSpec/PlaneBC fields and the same
(19, nx, ny, nz) float32 state layout, so crossing over is a field copy
and an array copy. Nothing here imports lbm_tpu: a reference spec is read
by attribute.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from lbm_tpu_torch.core.units import UnitSystem
from lbm_tpu_torch.engine.spec import CaseSpec, PlaneBC


def _array_or_none(v):
    return None if v is None else np.array(v, copy=True)


def _copy_fields(cls, ref, convert):
    out = {}
    for fld in dataclasses.fields(cls):
        v = getattr(ref, fld.name)
        out[fld.name] = convert.get(fld.name, copy.deepcopy)(v)
    return cls(**out)


def case_from_reference(spec) -> CaseSpec:
    """The port's CaseSpec for a lbm_tpu CaseSpec (read by attribute)."""
    bc_convert = {"u_field": _array_or_none, "u_series": _array_or_none}
    case_convert = {
        "units": lambda u: UnitSystem(CH=float(u.CH), C_U=float(u.C_U),
                                      C_rho=float(u.C_rho)),
        "mask": lambda m: np.array(m, copy=True),
        "rho0": _array_or_none,
        "u0": _array_or_none,
        "wall_sdf": _array_or_none,
        "shape": lambda s: tuple(int(v) for v in s),
        "boundaries": lambda bcs: [_copy_fields(PlaneBC, b, bc_convert)
                                   for b in bcs],
    }
    return _copy_fields(CaseSpec, spec, case_convert)


def state_from_numpy(f, device="cpu") -> torch.Tensor:
    """A (19, nx, ny, nz) array as the port's contiguous float32 state."""
    f = np.ascontiguousarray(np.asarray(f), dtype=np.float32)
    if f.ndim != 4 or f.shape[0] != 19:
        raise ValueError(f"state must be (19, nx, ny, nz), got {f.shape}")
    return torch.from_numpy(f).to(device, copy=True)


def state_to_numpy(f) -> np.ndarray:
    """The port's state as a (19, nx, ny, nz) float32 NumPy array."""
    return f.detach().cpu().numpy().astype(np.float32, copy=False)


__all__ = ["case_from_reference", "state_from_numpy", "state_to_numpy"]
