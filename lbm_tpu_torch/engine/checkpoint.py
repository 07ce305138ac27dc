"""Checkpoint / resume in lbm_tpu's portable npz layout (torch port of
lbm_tpu/engine/checkpoint.py).

State = (f, t, convergence window) plus case identity: f is the
unpadded (19, nx, ny, nz) float32 array, so a checkpoint written by
lbm_tpu resumes here and one written here resumes in lbm_tpu. The file
is written to a temporary name and renamed, so a crash never leaves a
half-written checkpoint. lbm_tpu's packed layout (512^3-class lowmem
runs) is not read yet.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save(path: str, f, t: int, case_name: str, meta: dict | None = None,
         compressed: bool = True) -> None:
    tmp = path + ".tmp"
    saver = np.savez_compressed if compressed else np.savez
    saver(
        tmp,
        f=np.asarray(f),
        t=np.int64(t),
        case=np.bytes_(case_name.encode()),
        meta=np.bytes_(json.dumps(meta or {}).encode()),
    )
    # np.savez appends .npz to names lacking it.
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def save_sim(path: str, sim, meta: dict | None = None) -> None:
    """Checkpoint a Simulation with its convergence window, so the first
    residual after a resume is taken against the pre-crash samples."""
    m = dict(meta or {})
    m["conv"] = {
        "last_velsum": sim._last_velsum,
        "last_usq": sim._last_usq,
    }
    save(path, sim.f_standard().cpu().numpy(), sim.t, sim.spec.name, m)


def load(path: str):
    with np.load(path) as data:
        f = data["f"]
        t = int(data["t"])
        case = bytes(data["case"]).decode()
        meta = json.loads(bytes(data["meta"]).decode())
    return f, t, case, meta


def restore(sim, path: str) -> None:
    """Restore a Simulation in place, verifying case identity and shape."""
    f, t, case, meta = load(path)
    if case != sim.spec.name:
        raise ValueError(
            f"checkpoint is for case {case!r}, simulation is {sim.spec.name!r}"
        )
    if (meta.get("layout") or {}).get("packed"):
        raise NotImplementedError(
            "packed (lowmem) checkpoints are not read by lbm_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 10)")
    if meta.get("wk") is not None:
        raise NotImplementedError(
            "checkpoint carries windkessel state; windkessel outlets are "
            "not ported yet (ROADMAP.md Queue 1 item 8)")
    if f.shape != (19,) + tuple(sim.spec.shape):
        raise ValueError(
            f"checkpoint shape {f.shape} != case {sim.spec.shape}")
    sim.set_f_standard(np.ascontiguousarray(f, dtype=np.float32))
    sim.t = t
    conv = meta.get("conv", {})
    sim._last_velsum = conv.get("last_velsum")
    sim._last_usq = conv.get("last_usq")


__all__ = ["save", "save_sim", "load", "restore"]
