"""Clinical plane diagnostics: flux, pressure, and CFD-FFR (a jax-free
copy of lbm_tpu/engine/diagnostics.py; NumPy on the host, so torch fields
are read to the host first).

The reference writes velocity and pressure fields and stops
(coronary_cfd/coronary.cu:948-1011 of the CUDA reference); the quantity
clinicians derive from exactly this kind of simulation is the
fractional flow reserve FFR = P_distal / P_proximal across a lesion,
estimated from the computed viscous pressure drop (the FFR-CT method:
FFR ~= (P_a - dp) / P_a with P_a the mean aortic pressure and dp the
trans-lesion drop from the CFD solution — pressure DIFFERENCES only,
so the solver's arbitrary gauge level cancels).

All helpers read the BC's consumer plane (one cell into the domain,
the same plane the NEE fixups and the windkessel flux use —
engine/compile.compile_bc), masked to the boundary footprint. Fields
may be NumPy arrays or torch tensors on any device.
"""

from __future__ import annotations

import numpy as np

MMHG_PER_PA = 1.0 / 133.322


def _plane(a, axis: int, c: int) -> np.ndarray:
    """Plane c of a field along axis as a NumPy array (of a torch tensor,
    only that plane is read to the host)."""
    if hasattr(a, "detach"):
        return a.detach().select(axis, c).cpu().numpy()
    return np.take(np.asarray(a), c, axis=axis)


def _consumer_plane(spec, bc_index: int):
    """(footprint bool (A, B), axis, consumer coord, outward sign)."""
    bc = spec.boundaries[bc_index]
    foot = np.take(np.asarray(spec.mask), bc.coord,
                   axis=bc.axis) == bc.mask_value
    return foot, bc.axis, bc.coord + bc.normal, float(-bc.normal)


def plane_flux(spec, u, bc_index: int) -> float:
    """Outward volume flux (lattice cells^3/step) through boundary
    `bc_index`'s consumer plane — the same footprint-masked sum the
    windkessel coupling integrates (engine/step.apply_bc_fixup), on a
    macro() velocity field."""
    foot, axis, c, sign = _consumer_plane(spec, bc_index)
    un = _plane(u[axis], axis, c)
    return sign * float(np.sum(un[foot], dtype=np.float64))


def plane_pressure(spec, rho, bc_index: int, gauge: float = 1.0) -> float:
    """Mean gauge pressure (lattice units, p = (rho - gauge)/3) over
    boundary `bc_index`'s consumer-plane footprint, from a macro()
    density field. Multiply by units.C_pre for Pa (equals
    units.to_physical_pressure(rho) - to_physical_pressure(gauge))."""
    foot, axis, c, _ = _consumer_plane(spec, bc_index)
    pl = _plane(rho, axis, c)
    return float((pl[foot].mean(dtype=np.float64) - gauge) / 3.0)


def ffr(spec, rho, inlet_index: int, outlet_index: int,
        p_aortic_mmhg: float = 90.0) -> tuple[float, float]:
    """(FFR estimate, trans-tree pressure drop in mmHg) between two
    boundaries' consumer planes: dp = p_in - p_out from the solved
    field (gauge level cancels), FFR = (P_a - dp)/P_a against a mean
    aortic pressure (90 mmHg default — the FFR-CT convention; <= 0.80
    reads ischemic)."""
    dp_lat = (plane_pressure(spec, rho, inlet_index)
              - plane_pressure(spec, rho, outlet_index))
    dp_mmhg = dp_lat * spec.units.C_pre * MMHG_PER_PA
    return (p_aortic_mmhg - dp_mmhg) / p_aortic_mmhg, dp_mmhg


__all__ = ["plane_flux", "plane_pressure", "ffr", "MMHG_PER_PA"]
