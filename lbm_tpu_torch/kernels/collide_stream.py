"""Wrappers for the Hopper collide-stream (K1a) and moments (K3) kernels,
their plain PyTorch versions, and launch counters.

  collide_stream  -> lbm_collide_stream_bgk (kernels/csrc/collide_stream.cu),
                     replacing lbm_tpu/kernels/collide_stream.py::_kernel
                     (BGK branch), ::_row_fix and the velsum
  macro           -> lbm_macro, replacing ::packed_macro

A wrapper runs the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. `launches` counts kernel
launches, one per wrapper call that launched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import moments
from lbm_tpu_torch.engine.compile import CompiledCase
from lbm_tpu_torch.engine.step import fluid_speed_sum, make_step

launches = {"lbm_collide_stream_bgk": 0, "lbm_macro": 0}

# ints per boundary descriptor row: kBCInts in csrc/collide_stream.cu
_BC_ROW = 11


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def collide_stream_plain(f, cc: CompiledCase):
    """The dense step plus the fluid velsum: (f', sum_fluid |u|) with the
    sum a float64 0-dim tensor."""
    f_new, _, u = make_step(cc)(f)
    return f_new, fluid_speed_sum(cc, u)


def macro_plain(f):
    """(rho, u) moments of every cell: core.lattice.moments."""
    return moments(f)


def _check_state(f, cc: CompiledCase, name: str) -> None:
    if f.dtype != torch.float32 or not f.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor")
    if tuple(f.shape) != (19,) + tuple(cc.shape):
        raise ValueError(f"{name} shape {tuple(f.shape)} != (19, *{cc.shape})")
    if f.device != cc.device:
        raise ValueError(f"{name} is on {f.device}, the case on {cc.device}")


def _bc_tables(cc: CompiledCase):
    """Host descriptor rows and device table pointers for the kernel."""
    n = len(cc.bcs)
    ints = np.zeros((max(n, 1), _BC_ROW), np.int32)
    floats = np.zeros((max(n, 1), 2), np.float32)
    valid = (ctypes.c_void_p * max(n, 1))()
    phis = (ctypes.c_void_p * max(n, 1))()
    for b, bc in enumerate(cc.bcs):
        lat_a = cc.shape[1] if bc.axis == 0 else cc.shape[0]
        extrap = bc.u_mode == "extrapolate"
        ints[b, :6] = (bc.axis, bc.consumer_coord, lat_a,
                       bc.rho_fixed is not None, extrap, len(bc.dirs))
        ints[b, 6 : 6 + len(bc.dirs)] = bc.dirs
        floats[b] = (0.0 if bc.rho_fixed is None else bc.rho_fixed, bc.omega)
        valid[b] = bc.valid.data_ptr()
        phis[b] = None if extrap else bc.phi_star.data_ptr()
    return ints, floats, valid, phis


def collide_stream(f, out, cc: CompiledCase, series, t: int):
    """One BGK step of f into out (a different buffer); writes the fluid
    velsum, sum over fluid cells of |u| after the NEE rewrite, into
    series[t] (float64). Returns out."""
    _check_state(f, cc, "f")
    _check_state(out, cc, "out")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {f.device}")
    if out.data_ptr() == f.data_ptr():
        raise ValueError("collide_stream reads neighbors: out must not be f")
    if series.dtype != torch.float64 or series.device != f.device \
            or series.dim() != 1 or not 0 <= t < series.numel():
        raise ValueError("series must be a 1-D float64 tensor on f's device "
                         "with t inside it")
    if f.device.type == "cpu":
        f_new, vs = collide_stream_plain(f, cc)
        out.copy_(f_new)
        series[t] = vs
        return out
    from lbm_tpu_torch.kernels._build import check, load_library

    lib = load_library().lib
    nx, ny, nz = cc.shape
    n_cells = nx * ny * nz
    if n_cells >= 2**31:
        raise ValueError(f"{n_cells} cells: the kernel indexes cells in int32")
    block = lib.lbm_block_size()
    n_partials = -(-n_cells // block)
    partials = torch.empty(n_partials, dtype=torch.float64, device=f.device)
    ints, floats, valid, phis = _bc_tables(cc)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = lib.lbm_collide_stream_bgk(
            f.data_ptr(), out.data_ptr(), cc.mask.data_ptr(),
            nx, ny, nz, cc.tau,
            len(cc.bcs), ints.ctypes.data, floats.ctypes.data,
            ctypes.addressof(valid), ctypes.addressof(phis),
            partials.data_ptr(), n_partials,
            series.data_ptr(), t, stream)
    check(lib, err, "lbm_collide_stream_bgk")
    launches["lbm_collide_stream_bgk"] += 1
    return out


def macro(f):
    """(rho (X, Y, Z), u (3, X, Y, Z)) moments of every cell of a
    (19, X, Y, Z) float32 state."""
    if f.dtype != torch.float32 or not f.is_contiguous() or f.dim() != 4 \
            or f.shape[0] != 19:
        raise ValueError("f must be a contiguous (19, X, Y, Z) float32 tensor")
    if f.device.type == "cpu":
        return macro_plain(f)
    if f.device.type != "cuda":
        raise ValueError(f"no kernel for device {f.device}")
    from lbm_tpu_torch.kernels._build import check, load_library

    lib = load_library().lib
    rho = torch.empty(f.shape[1:], dtype=torch.float32, device=f.device)
    u = torch.empty((3,) + tuple(f.shape[1:]), dtype=torch.float32,
                    device=f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = lib.lbm_macro(f.data_ptr(), rho.data_ptr(), u.data_ptr(),
                            rho.numel(), stream)
    check(lib, err, "lbm_macro")
    launches["lbm_macro"] += 1
    return rho, u


__all__ = ["collide_stream", "collide_stream_plain", "macro", "macro_plain",
           "launches", "reset_launches"]
