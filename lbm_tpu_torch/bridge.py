"""Carry case specs and states across from lbm_tpu.

Both packages keep the same CaseSpec/PlaneBC fields and the same
(19, nx, ny, nz) float32 state layout, so crossing over is a field copy
and an array copy. A transport (scalar, coupled or buoyant) crosses as
its g state in the (7, nx, ny, nz) layout, its flow state, its step and
its constructor arguments; lbm_tpu's Pallas classes keep g and f packed
as (nx + 2 + px, ny + 2 + py, C, nz + pz) with a one-cell ring in x and
y and alignment padding at the ends, which `unpack_lattice` undoes. A
bf16 state (lbm_tpu's store_dtype='bf16': an ml_dtypes bfloat16 array, or
the |V2 void array that np.savez leaves of one) is widened to float32 bit
for bit on the way in (`as_float32`). A state split along one axis
over `world` ranks crosses as each rank's window (`shard_window`: the
rank's ceil(n / world) rows, the rows past the box filled) and comes
back whole (`gather_windows`).
A sparse state crosses as lbm_tpu's compacted (19, n_pad) array without
its lane padding (`sparse_state_from_reference`, and back).
An IBMFlow, ShanChen or BinaryFluid crosses as its (f, g, t)
(`lattice_state_from_reference`, `lattice_state_to_numpy`), adjoint's RCR
parameters as an (n_wk, 3) theta array (`theta_from_numpy`).
Nothing here imports lbm_tpu: a reference object is read by attribute.
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


def as_float32(a) -> np.ndarray:
    """An array as float32: bf16 words (a 2-byte void array, as np.savez
    stores ml_dtypes bfloat16) widened bit for bit (the 16 bits become the
    high half of a float32), an ml_dtypes bfloat16 array through astype,
    anything else converted as NumPy converts it."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
        return (bits << np.uint32(16)).view(np.float32)
    return a.astype(np.float32, copy=False)


def state_from_numpy(f, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """A (19, nx, ny, nz) array (float32, or bf16 words widened by
    as_float32) as the port's contiguous state in `dtype` (float32, or
    bfloat16 for a store_dtype='bf16' run: narrowed with round-to-nearest-
    even, exact for a state that was bf16)."""
    f = np.ascontiguousarray(as_float32(f))
    if f.ndim != 4 or f.shape[0] != 19:
        raise ValueError(f"state must be (19, nx, ny, nz), got {f.shape}")
    return torch.from_numpy(f).to(device, copy=True).to(dtype)


def state_to_numpy(f) -> np.ndarray:
    """The port's state as a (19, nx, ny, nz) float32 NumPy array (a bf16
    state widened)."""
    return f.detach().cpu().float().numpy()


def sparse_state_from_reference(sc, f_s, device="cpu") -> torch.Tensor:
    """lbm_tpu's compacted (19, n_pad) sparse state (its SparseCase `sc`,
    read by attribute) as the port's (19, n_live) float32 state: the lane
    padding dropped; both packages compact in the same order."""
    f = np.asarray(f_s, np.float32)
    if f.ndim != 2 or f.shape[0] != 19 or f.shape[1] != int(sc.n_pad):
        raise ValueError(f"sparse state must be (19, {sc.n_pad}), got "
                         f"{f.shape}")
    return torch.from_numpy(np.ascontiguousarray(f[:, :int(sc.n_live)])).to(
        device)


def sparse_state_to_reference(sc, f_s) -> np.ndarray:
    """The port's (19, n_live) sparse state as lbm_tpu's (19, n_pad) for
    its SparseCase `sc`, the pad zeros."""
    f = f_s.detach().cpu().float().numpy()
    if f.shape != (19, int(sc.n_live)):
        raise ValueError(f"sparse state must be (19, {sc.n_live}), got "
                         f"{f.shape}")
    out = np.zeros((19, int(sc.n_pad)), np.float32)
    out[:, :f.shape[1]] = f
    return out


def unpack_lattice(packed, shape, channels: int, ring: int = 1):
    """A packed (X + 2 ring + px, Y + 2 ring + py, C, Z + pz) array of
    lbm_tpu's Pallas kernels as the dense (channels, X, Y, Z) float32
    array of the unpadded box `shape`: channels first, the ring and the
    end padding cut off, the alignment channels dropped, a bf16 payload
    widened (as_float32)."""
    p = np.asarray(packed)
    nx, ny, nz = (int(v) for v in shape)
    if p.ndim != 4 or p.shape[2] < channels or p.shape[0] < nx + 2 * ring \
            or p.shape[1] < ny + 2 * ring or p.shape[3] < nz:
        raise ValueError(f"packed shape {p.shape} does not hold "
                         f"{channels} channels of a {shape} box")
    return np.ascontiguousarray(as_float32(
        p[ring:ring + nx, ring:ring + ny, :channels, :nz]
        .transpose(2, 0, 1, 3)))


def shard_window(f, rank: int, world: int, axis: int, lead: int = 1,
                 fill=0):
    """Rank `rank`'s window of a field split along lattice axis `axis`
    into `world` windows of ceil(n / world) rows (engine/compile.
    shard_rows), rows past the box filled with `fill`. f: a NumPy array
    or a tensor of `lead` leading dims before the three lattice axes
    (1 for a (19, X, Y, Z) state, 0 for a mask); the window is of f's
    kind, a copy."""
    dim = lead + axis
    n = f.shape[dim]
    rows = -(-n // world)
    lo, hi = min(rank * rows, n), min((rank + 1) * rows, n)
    sl = [slice(None)] * f.ndim
    sl[dim] = slice(lo, hi)
    own = f[tuple(sl)]
    pad_shape = list(f.shape)
    pad_shape[dim] = rows - (hi - lo)
    if torch.is_tensor(f):
        pad = torch.full(pad_shape, fill, dtype=f.dtype, device=f.device)
        return torch.cat([own, pad], dim=dim).contiguous()
    pad = np.full(pad_shape, fill, dtype=f.dtype)
    return np.ascontiguousarray(np.concatenate([own, pad], axis=dim))


def gather_windows(windows, axis: int, n: int, lead: int = 1):
    """The whole field of n rows along `axis` from the ranks' windows in
    rank order (NumPy arrays or tensors): shard_window's inverse."""
    dim = lead + axis
    if torch.is_tensor(windows[0]):
        return torch.cat(list(windows), dim=dim).narrow(dim, 0, n)
    whole = np.concatenate(list(windows), axis=dim)
    return np.ascontiguousarray(np.take(whole, np.arange(n), axis=dim))


def transport_state_from_reference(tr) -> dict:
    """{"g", "f", "t", "wk"} of a lbm_tpu transport as NumPy arrays in
    the port's layouts: g (7, X, Y, Z) from the dense classes' (7, X, Y,
    Z) or the Pallas classes' packed g; f (19, X, Y, Z) from `f` or the
    packed `p` (None for the frozen classes); t the step count; wk the
    (n_wk,) float32 windkessel P_c of a coupled one (None without
    windkessel outlets)."""
    shape = tuple(int(v) for v in tr.spec.shape)
    g = np.asarray(tr.g)
    g = (np.ascontiguousarray(g, dtype=np.float32) if g.shape[0] == 7
         and g.shape[1:] == shape else unpack_lattice(g, shape, 7))
    f = None
    if hasattr(tr, "p"):
        f = unpack_lattice(tr.p, shape, 19)
    elif hasattr(tr, "f"):
        f = np.ascontiguousarray(np.asarray(tr.f), dtype=np.float32)
    wk = getattr(tr, "wk", None)
    wk = (None if wk is None or np.asarray(wk).size == 0
          else np.asarray(wk, np.float32).copy())
    return {"g": g, "f": f, "t": int(tr.t), "wk": wk}


def load_transport_state(transport, state: dict) -> None:
    """Load a transport_state_from_reference dict into a port transport
    (both buffers of each state)."""
    transport.set_g(state["g"])
    if state.get("f") is not None:
        transport.set_f(state["f"])
    if state.get("wk") is not None:
        transport.wk = torch.as_tensor(
            np.asarray(state["wk"], np.float32)).to(transport.cc.device)
    transport.t = int(state["t"])


def transport_kwargs_from_reference(tr, u=None, wall_c=None, c0=None) -> dict:
    """Constructor arguments of the port's counterpart of a lbm_tpu
    transport: tau_g and source read by attribute, buoyancy and c_ref of
    a buoyant one, and the arrays the caller gave lbm_tpu (the frozen u,
    wall_c, c0), copied as float32 NumPy arrays. inlet_c is not carried:
    lbm_tpu's callables are traced, the port's take the integer step."""
    kw = {"tau_g": float(tr.tau_g), "source": float(tr.source)}
    if hasattr(tr, "buoyancy") or hasattr(tr, "_buoy"):
        buoy = tr.buoyancy if hasattr(tr, "buoyancy") else tr._buoy
        kw["buoyancy"] = tuple(float(v) for v in np.asarray(buoy))
        kw["c_ref"] = float(tr.c_ref if hasattr(tr, "c_ref") else tr._cref)
    for name, arr in (("u", u), ("wall_c", wall_c), ("c0", c0)):
        if arr is not None:
            kw[name] = np.array(arr, dtype=np.float32, copy=True)
    return kw


def lattice_state_from_reference(obj) -> dict:
    """{"f", "g", "t"} of a lbm_tpu IBMFlow, ShanChen or BinaryFluid (read
    by attribute) as NumPy float32 arrays in the port's layouts: f (19, X,
    Y, Z), g the (7, X, Y, Z) order-parameter state of a BinaryFluid (None
    for the others), t the step count. The same dict of a port object is
    lattice_state_to_numpy's, so either package can start from it."""
    g = getattr(obj, "g", None)
    return {"f": np.array(obj.f, dtype=np.float32, copy=True),
            "g": None if g is None else np.array(g, dtype=np.float32,
                                                   copy=True),
            "t": int(obj.t)}


def lattice_state_to_numpy(obj) -> dict:
    """{"f", "g", "t"} of a port IBMFlow, ShanChen or BinaryFluid as NumPy
    float32 arrays (g None but for a BinaryFluid): lbm_tpu's objects take
    them as jnp.asarray(state["f"]) and so on."""
    g = getattr(obj, "g", None)
    return {"f": obj.f.detach().cpu().float().numpy().copy(),
            "g": None if g is None else g.detach().cpu().float().numpy()
            .copy(),
            "t": int(obj.t)}


def load_lattice_state(obj, state: dict) -> None:
    """Load a lattice_state_from_reference dict into a port IBMFlow,
    ShanChen or BinaryFluid, on the object's device."""
    dev = obj.cc.device
    f = np.asarray(state["f"], np.float32)
    if f.shape != tuple(obj.f.shape):
        raise ValueError(f"f shape {f.shape} != {tuple(obj.f.shape)}")
    obj.f = torch.from_numpy(np.ascontiguousarray(f)).to(dev, copy=True)
    if state.get("g") is not None:
        if not hasattr(obj, "g"):
            raise ValueError("the state has g, the object has none")
        obj.g = torch.from_numpy(np.ascontiguousarray(
            np.asarray(state["g"], np.float32))).to(dev, copy=True)
    obj.t = int(state["t"])


def theta_from_numpy(theta, device="cpu", requires_grad: bool = False):
    """An (n_wk, 3) (Rp, C, Rd) array (lbm_tpu's adjoint.wk_params or a
    jax array) as the port's fp32 theta tensor on `device`."""
    th = np.array(theta, dtype=np.float32, copy=True)
    if th.ndim != 2 or th.shape[1] != 3:
        raise ValueError(f"theta must be (n_wk, 3), got {th.shape}")
    return torch.from_numpy(th).to(device).requires_grad_(requires_grad)


def theta_to_numpy(theta) -> np.ndarray:
    """The port's theta tensor (or an array) as an (n_wk, 3) float32 NumPy
    array, for lbm_tpu's rollout."""
    if torch.is_tensor(theta):
        return theta.detach().cpu().float().numpy().copy()
    return np.array(theta, dtype=np.float32, copy=True)


__all__ = ["case_from_reference", "as_float32", "state_from_numpy",
           "state_to_numpy", "shard_window", "gather_windows",
           "unpack_lattice", "transport_state_from_reference",
           "load_transport_state", "transport_kwargs_from_reference",
           "lattice_state_from_reference", "lattice_state_to_numpy",
           "load_lattice_state", "theta_from_numpy", "theta_to_numpy"]
