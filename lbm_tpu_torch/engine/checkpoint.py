"""Checkpoint / resume in lbm_tpu's portable npz layout (torch port of
lbm_tpu/engine/checkpoint.py).

State = (f, t, convergence window) plus case identity: f is the
unpadded (19, nx, ny, nz) float32 array, so a checkpoint written by
lbm_tpu resumes here and one written here resumes in lbm_tpu. The file
is written to a temporary name and renamed, so a crash never leaves a
half-written checkpoint. A lowmem Simulation writes the same layout,
read to the host in chunks, uncompressed (compressing a 512^3-class
state costs minutes of host CPU for little, as lbm_tpu found). lbm_tpu's
packed layout (its lowmem checkpoints: the padded (X, Y, C, Z) state
with `layout` meta) is cropped to the portable one on the host, as
lbm_tpu's restore does for a target that is not its own lowmem run. A
packed bf16 state (lbm_tpu's bf16 lowmem runs; np.savez stores its
bfloat16 words as |V2 void, which lbm_tpu's own restore cannot read) is
widened to float32 bit for bit on the host. Every file restores into a
run of either storage dtype (set_f_standard narrows into a bf16 run);
save_sim writes float32 in both, so the port never writes a |V2 file.
Under a mesh every rank calls save_sim and restore: rank 0 writes the
gathered whole box (zeros at DEAD cells) and the others wait for it,
and every rank reads the file and keeps its own window, so a file
saved by a run of N ranks restores into a run of M ranks or none.
A run with windkessel outlets writes their carried P_c as meta["wk"], as
lbm_tpu does, and restore reads it back into sim.wk from the port's files
and from lbm_tpu's.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from lbm_tpu_torch.bridge import unpack_lattice


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
    if getattr(sim, "wk", None) is not None:
        # the windkessel outlets' carried P_c (one host read, at save)
        m["wk"] = [float(v) for v in sim.wk.cpu().numpy()]
    f = sim.f_standard()
    if sim.mesh is None or sim.mesh.rank == 0:
        save(path, f.cpu().numpy(), sim.t, sim.spec.name, m,
             compressed=not sim.lowmem)
    if sim.mesh is not None:
        sim.mesh.barrier()


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
    wk = meta.get("wk")
    if wk is not None and getattr(sim, "wk", None) is None:
        raise ValueError("checkpoint carries windkessel state but the "
                         "target case has no windkessel outlets")
    if wk is not None and len(wk) != sim.wk.numel():
        raise ValueError(f"checkpoint carries {len(wk)} windkessel states, "
                         f"the case has {sim.wk.numel()} outlets")
    lay = meta.get("layout") or {}
    if lay.get("packed"):
        if lay.get("dtype") not in ("float32", "bfloat16"):
            raise ValueError(f"a packed checkpoint of {lay.get('dtype')} "
                             "storage: lbm_tpu stores float32 or bfloat16")
        f = unpack_lattice(f, sim.spec.shape, 19, int(lay["ring"]))
    if f.shape != (19,) + tuple(sim.spec.shape):
        raise ValueError(
            f"checkpoint shape {f.shape} != case {sim.spec.shape}")
    # both ping-pong buffers: the kernel backend never writes a
    # non-fluid cell
    sim.set_f_standard(np.ascontiguousarray(f, dtype=np.float32))
    sim.t = t
    conv = meta.get("conv", {})
    sim._last_velsum = conv.get("last_velsum")
    sim._last_usq = conv.get("last_usq")
    if wk is not None:
        sim.wk = torch.tensor(wk, dtype=torch.float32, device=sim.device)


__all__ = ["save", "save_sim", "load", "restore"]
