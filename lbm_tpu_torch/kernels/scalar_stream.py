"""Wrapper for the Hopper D3Q7 scalar kernel (K7 and K8), its plain
PyTorch version, and its launch counter.

  scalar_stream -> lbm_scalar_stream (kernels/csrc/scalar_stream.cu),
                   replacing lbm_tpu/kernels/scalar_stream.py::_kernel7
                   in both modes: the frozen-field body _subtile7 (K7:
                   ScalarCase.u set) and the coupled body _subtile7f (K8:
                   the flow's post-collision state `f` given, the
                   velocity rebuilt per cell, with the Boussinesq force
                   of the pre-update scalar under ScalarCase.force). The
                   boundary planes' rewrite, the Dirichlet walls and the
                   washout record, which lbm_tpu computes outside its
                   kernel on slabs cut and spliced with ::_extract_z_slab
                   and ::_splice_z_plane_inplace at nch=7, run inside the
                   same launch.

The kernel is a template over <live u, comp, force, Dirichlet walls>;
`instance(sc, live)` names the one a launch runs ("frozen+comp",
"live+force+dirichlet", ...). The wrapper runs the plain version only for
tensors on the CPU; for a CUDA tensor it launches the kernel or raises.
`launches` counts kernel launches per instance ("lbm_scalar_stream
[frozen+comp]"), one per wrapper call that launched.

The classes that drive it are engine/scalar.ScalarTransport and
CoupledTransport and engine/thermal.BuoyantTransport with
backend='kernel': the counterparts of lbm_tpu's ScalarTransportPallas,
CoupledTransportPallas and BuoyantTransportPallas. Under a mesh
ScalarTransport launches the same kernel on each rank's halo-row block
(engine/scalar.ScalarShard, lbm_tpu's ScalarTransportPallas(mesh=)):
its cell and footprint lists hold the rank's own rows, each boundary
counts its whole footprint, so the record row is the rank's share.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import numpy as np
import torch

from lbm_tpu_torch.engine.scalar import (
    Q7,
    ScalarCase,
    live_velocity,
    phi7,
    plane_means,
    transport_pass,
)

launches: dict[str, int] = {}

# The parameter rows (enums SInt/SFloat in csrc/scalar_stream.cu; a CPU
# test compares the two) and the widths of a boundary's rows (kBCInts,
# kBCFloats there).
SINT = {"live": 0, "comp": 1, "force": 2, "dirichlet": 3, "source": 4,
        "n": 5}
SFLOAT = {"inv_tau": 0, "omega": 1, "source": 2, "buoy": 3, "c_ref": 6,
          "base": 7, "n": 10}
BC_INTS, BC_FLOATS = 4, 2
MAX_BCS = 8   # kMaxBCs there: boundary descriptors passed by value


def reset_launches() -> None:
    launches.clear()


def instance(sc: ScalarCase, live: bool) -> str:
    """The kernel instance a launch runs: 'frozen' or 'live', then
    '+comp' (frozen, div_fix), '+force' (live, a force in the velocity)
    and '+dirichlet'."""
    parts = ["live" if live else "frozen"]
    if not live and sc.comp is not None:
        parts.append("comp")
    if live and sc.force is not None:
        parts.append("force")
    if sc.wall_c is not None:
        parts.append("dirichlet")
    return "+".join(parts)


def param_rows(sc: ScalarCase, live: bool):
    """(int32 row, float32 row) of the kernel's parameters at the
    SINT/SFLOAT offsets, the plain pass's constants."""
    si = np.zeros(SINT["n"], np.int32)
    sf = np.zeros(SFLOAT["n"], np.float32)
    si[SINT["live"]] = live
    si[SINT["comp"]] = not live and sc.comp is not None
    si[SINT["force"]] = live and sc.force is not None
    si[SINT["dirichlet"]] = sc.wall_c is not None
    si[SINT["source"]] = bool(sc.source)
    sf[SFLOAT["inv_tau"]] = sc.inv_tau
    sf[SFLOAT["omega"]] = sc.omega
    sf[SFLOAT["source"]] = sc.source
    if live and sc.force is not None:
        buoy, c_ref, base = sc.force
        sf[SFLOAT["buoy"]:SFLOAT["buoy"] + 3] = buoy
        sf[SFLOAT["c_ref"]] = c_ref
        sf[SFLOAT["base"]:SFLOAT["base"] + 3] = base
    return si, sf


def scalar_stream_plain(g, sc: ScalarCase, t: int, f=None):
    """One plain step of g at integer step t: (g', record) with record
    the (n_bc,) float64 means of the post-stream c over each boundary's
    footprint. f: the flow's post-collision state (the live velocity of
    the coupled mode); without it the frozen sc.u is used."""
    if f is None:
        if sc.u is None:
            raise ValueError("no velocity: the case has no frozen u and no "
                             "flow state f was given")
        phi, comp = sc.phi, sc.comp
    else:
        phi = phi7(live_velocity(f, g, sc.fluid, sc.blocked_axes, sc.force))
        comp = None
    g_new, c = transport_pass(g, t, phi, sc.nbr_block, sc.bcs, sc.omega,
                              sc.inv_tau, comp, sc.source, sc.fluid,
                              sc.dirichlet)
    return g_new, plane_means(c, sc.bcs)


def coupled_step_plain(f, g, cc, sc: ScalarCase, t: int, field=None):
    """One plain step of the coupled kernel route: the flow's plain step
    (with the force field of the pre-step g, if any), then the scalar's
    plain step in the new flow state's velocity: (f', g', record,
    velsum)."""
    from lbm_tpu_torch.kernels.collide_stream import step_plain

    f_new, vs = step_plain(f, cc, t, field, None if field is None else g)
    g_new, rec = scalar_stream_plain(g, sc, t, f=f_new)
    return f_new, g_new, rec, vs


# The wrapper's scratch per case, dropped with the case: one _Launch per
# mode (frozen or live velocity).
_scratch: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


class _Launch:
    """What a case's launches share, built once: the C entry, the counter
    name, the parameter and boundary rows, the ctypes pointer arrays, the
    plane buffers and every argument that does not change with the step.
    Per step only the state pointers, the record row and the c* of
    boundaries whose c* is a function of the step move."""

    def __init__(self, sc: ScalarCase, live: bool):
        from lbm_tpu_torch.kernels._build import load_scalar_library

        self.lib = load_scalar_library().lib
        self.entry = self.lib.lbm_scalar_stream
        self.name = f"lbm_scalar_stream[{instance(sc, live)}]"
        self.si, self.sf = param_rows(sc, live)
        n = max(len(sc.bcs), 1)
        self.ints = np.zeros((n, BC_INTS), np.int32)
        self.floats = np.zeros((n, BC_FLOATS), np.float32)
        self.valid = (ctypes.c_void_p * n)()
        self.cplane = (ctypes.c_void_p * n)()
        self.planes = []
        for b, bc in enumerate(sc.bcs):
            self.ints[b, :3] = (bc.axis, bc.coord, bc.dir)
            self.floats[b, 1] = bc.count
            self.planes.append(torch.zeros(bc.valid.shape,
                                           dtype=torch.float32,
                                           device=sc.device))
            self.valid[b] = bc.valid.data_ptr()
            self.cplane[b] = self.planes[b].data_ptr()
            self._set_c_star(b, bc.c_star_at(0))
        # the boundaries whose c* moves with the step
        self.moving = [(b, bc) for b, bc in enumerate(sc.bcs)
                       if callable(bc.c_fn)]
        self.foot_off = np.ascontiguousarray(sc.foot_off, np.int32)
        nx, ny, nz = sc.shape
        ids = sc.cells
        self.head = (sc.mask.data_ptr(), nx, ny, nz,
                     None if live else sc.u.data_ptr())
        self.tail = (
            None if live or sc.comp is None else sc.comp.data_ptr(),
            None if sc.wall_c is None else sc.wall_c.data_ptr(),
            self.si.ctypes.data, self.sf.ctypes.data, len(sc.bcs),
            self.ints.ctypes.data, self.floats.ctypes.data,
            ctypes.addressof(self.valid), ctypes.addressof(self.cplane),
            sc.foot.data_ptr(), self.foot_off.ctypes.data,
            None if ids is None else ids.data_ptr(),
            nx * ny * nz if ids is None else ids.numel())

    def _set_c_star(self, b: int, c_star) -> None:
        self.ints[b, 3] = c_star is not None
        self.floats[b, 0] = 0.0 if c_star is None else c_star

    def __call__(self, g, out, f, t: int, row, stream) -> int:
        for b, bc in self.moving:
            self._set_c_star(b, bc.c_star_at(t))
        return self.entry(g.data_ptr(), out.data_ptr(), *self.head,
                          None if f is None else f.data_ptr(), *self.tail,
                          row, stream)


def _launch(sc: ScalarCase, live: bool) -> _Launch:
    per_case = _scratch.setdefault(sc, {})
    if live not in per_case:
        per_case[live] = _Launch(sc, live)
    return per_case[live]


def _check_g(g, sc: ScalarCase, name: str) -> None:
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor")
    if tuple(g.shape) != (Q7,) + sc.shape:
        raise ValueError(f"{name} shape {tuple(g.shape)} != (7, *{sc.shape})")
    if g.device != sc.device:
        raise ValueError(f"{name} is on {g.device}, the case on {sc.device}")


def scalar_stream(g, out, sc: ScalarCase, t: int, f=None,
                  series: Optional[torch.Tensor] = None, slot: int = 0):
    """One step of g into out (a different buffer) at integer step t.
    Only fluid cells are written: out must already hold g's non-fluid
    cells (zeros from set-up on, in both buffers). f: the flow's
    post-collision (19, X, Y, Z) state, for the live velocity (K8);
    without it the frozen sc.u advects (K7). series: a (steps, n_bc)
    float64 tensor whose row `slot` gets each boundary's record, or
    None. The launch takes a thread a cell of the case's list (sc.cells:
    the fluid cells and those under a footprint on its consumer plane),
    or of the box when there is no list. Returns out."""
    _check_g(g, sc, "g")
    _check_g(out, sc, "out")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {g.device}")
    if out.data_ptr() == g.data_ptr():
        raise ValueError("the step reads neighbors: out must not be g")
    live = f is not None
    if live:
        if f.dtype != torch.float32 or not f.is_contiguous() \
                or tuple(f.shape) != (19,) + sc.shape or f.device != g.device:
            raise ValueError("f must be a contiguous float32 "
                             f"(19, *{sc.shape}) tensor on {g.device}")
    elif sc.u is None:
        raise ValueError("no velocity: the case has no frozen u and no flow "
                         "state f was given")
    n_bc = len(sc.bcs)
    if n_bc > MAX_BCS:
        raise NotImplementedError(
            f"{n_bc} boundary planes: the scalar kernel takes at most "
            f"{MAX_BCS}")
    if series is not None and (
            series.dtype != torch.float64 or series.device != g.device
            or series.dim() != 2 or series.shape[1] != n_bc
            or not series.is_contiguous()
            or not 0 <= slot < series.shape[0]):
        raise ValueError("series must be a contiguous (steps, n_bc) float64 "
                         "tensor on g's device with the slot inside it")
    if g.device.type == "cpu":
        g_new, rec = scalar_stream_plain(g, sc, t, f)
        out.copy_(g_new)
        if series is not None:
            series[slot] = rec
        return out
    from lbm_tpu_torch.kernels._build import check

    n_cells = sc.shape[0] * sc.shape[1] * sc.shape[2]
    if n_cells >= 2**31:
        raise ValueError(f"{n_cells} cells: the kernel indexes cells in int32")
    launch = _launch(sc, live)
    row = None
    if series is not None and n_bc:
        row = series.data_ptr() + slot * n_bc * 8
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = launch(g, out, f, t, row, stream)
    check(launch.lib, err, launch.name)
    launches[launch.name] = launches.get(launch.name, 0) + 1
    return out


__all__ = ["scalar_stream", "scalar_stream_plain", "coupled_step_plain",
           "instance", "param_rows",
           "launches", "reset_launches", "SINT", "SFLOAT", "BC_INTS",
           "BC_FLOATS", "MAX_BCS"]
