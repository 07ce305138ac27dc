"""Every output surface of a 512^3 run (the port of lbm_tpu's
tools/demo_512_outputs.py): the 512^3 synthetic coronary tree on the
kernel route (the list K1 over its fluid cells, its three z outlets in
the same launch), lowmem by its size (one fp32 state is 10.2 GB, past
runner.LOWMEM_BYTES), then at that size:

  - macro() through K3, |u|max read without a second full-size copy;
  - wss() through the live-cell stress (5 * 19 * 4 * cells > 6e9), the
    live cells' populations gathered straight out of the state;
  - a binary VTK with DENSITY, PRESSURE and VELOCITY (~2.6 GB);
  - an uncompressed checkpoint (engine/checkpoint.save_sim: f_standard()
    is K4's chunked read to host memory, ~10.2 GB on disk), the run
    freed, a fresh Simulation restored from it and stepped further.

The velsum printed for a chunk is the sum of its steps' fluid velsums
(the runner's series less the case's constant non-fluid offset), the
quantity lbm_tpu's fori_loop carry sums.

Memory at 512^3: two state buffers of 10.2 GB on the card (macro() adds
2.1 GB, wss() ~1 GB of live-cell tables); on the host the checkpoint's
10.2 GB read, the VTK's ~5 float32 copies of the box, and the
checkpoint's 10.2 GB load at restore. Disk: ~2.6 GB VTK + 10.2 GB
checkpoint under --out.

Usage: python -m lbm_tpu_torch.tools.demo_512_outputs [--steps 20]
         [--n 512] [--out DIR] [--resume-steps 5] [--force-lowmem]
         [--no-vtk] [--no-ckpt] [--resume-only] [--device cuda]
Smoke: --n 36 --force-lowmem --steps 4 --resume-steps 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from lbm_tpu_torch.tools import coronary_cube, device_label, sync

CKPT_NAME = "demo512.ckpt.npz"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "demo512"))
    ap.add_argument("--resume-steps", type=int, default=5)
    ap.add_argument("--force-lowmem", action="store_true",
                    help="take the lowmem read below its size threshold "
                    "(CPU smoke runs)")
    ap.add_argument("--no-vtk", action="store_true",
                    help="skip the VTK stage")
    ap.add_argument("--no-ckpt", action="store_true",
                    help="skip the checkpoint and resume stages")
    ap.add_argument("--resume-only", action="store_true",
                    help="only restore from the checkpoint in --out and "
                    "step it")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    return ap.parse_args(argv)


def live_cells(spec) -> int:
    from lbm_tpu_torch.geometry.mask import CellType

    return int((np.asarray(spec.mask) != CellType.DEAD).sum())


def make_sim(spec, device, force_lowmem: bool):
    """Simulation(spec, backend='kernel'), lowmem by its size (or forced);
    a run that does not take the lowmem read fails."""
    from lbm_tpu_torch.engine.runner import Simulation

    sim = Simulation(spec, device=device, backend="kernel",
                     lowmem=True if force_lowmem else None)
    if not sim.lowmem:
        raise RuntimeError("a 512^3-class run must take the lowmem path "
                           f"(shape {spec.shape}; --force-lowmem below it)")
    return sim


def chunk(sim, steps: int) -> tuple[np.ndarray, float]:
    """(the chunk's per-step fluid velsums, seconds): one runner chunk of
    `steps` steps; a velsum that is not finite fails."""
    res = sim.run(max_steps=steps, time_save=steps, verbose=False)
    vs = res.velsum_series - sim.case.velsum_offset
    if not np.isfinite(vs).all():
        raise RuntimeError(f"velsum {vs} up to step {sim.t}")
    return vs, res.elapsed_s


def u_max(sim) -> float:
    """max |u_i| over the box of macro() (K3), by aminmax: no second
    full-size array."""
    import torch

    _, u = sim.macro()
    lo, hi = torch.aminmax(u)
    del u
    return max(-float(lo), float(hi))


def wss_stats(sim) -> dict:
    """wss() (the live-cell route at 512^3) reduced on its device: the
    cells with WSS > 0, their mean and the max in Pa, the call's seconds
    (the first call builds the live-cell tables and the wall normals)."""
    import torch

    t0 = time.perf_counter()
    w = sim.wss()
    sync(w.device)
    seconds = time.perf_counter() - t0
    count = int((w > 0).sum())
    total = float(w.sum(dtype=torch.float64))
    top = float(w.max())
    del w
    cpre = sim.spec.units.C_pre
    return {"count": count, "mean_pa": total / max(count, 1) * cpre,
            "max_pa": top * cpre, "seconds": seconds}


def write_vtk(sim, out_dir: str) -> tuple[str, float]:
    """(path, seconds) of the binary VTK with DENSITY, PRESSURE and
    VELOCITY."""
    from lbm_tpu_torch.io.vtk import case_vtk

    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    path = case_vtk(sim, out_dir, sim.t, include_density=True, binary=True)
    return path, time.perf_counter() - t0


def write_checkpoint(sim, path: str) -> float:
    """Seconds of save_sim (uncompressed under lowmem: K4's chunked read
    of the state to host memory, then np.savez)."""
    from lbm_tpu_torch.engine import checkpoint

    if not sim.lowmem:
        raise RuntimeError("the 512^3 checkpoint is the lowmem run's")
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    checkpoint.save_sim(path, sim)
    return time.perf_counter() - t0


def restore_sim(spec, path: str, device, force_lowmem: bool):
    """(a fresh Simulation restored from the checkpoint at `path`,
    seconds of the construction and the restore)."""
    from lbm_tpu_torch.engine import checkpoint

    t0 = time.perf_counter()
    sim = make_sim(spec, device, force_lowmem)
    checkpoint.restore(sim, path)
    sync(sim.device)
    return sim, time.perf_counter() - t0


def resume_stage(spec, args, out: dict) -> None:
    """Restore from --out's checkpoint and take --resume-steps steps."""
    sim, seconds = restore_sim(spec, os.path.join(args.out, CKPT_NAME),
                               args.device, args.force_lowmem)
    print(f"restored t={sim.t} in {seconds:.1f}s (incl. fresh init + "
          "state upload)", flush=True)
    s = float(chunk(sim, args.resume_steps)[0].sum())
    print(f"resume: {args.resume_steps} more steps from the checkpoint, "
          f"velsum {s:.4e} (finite)", flush=True)
    out.update(resume_velsum=s, resume_t=sim.t)


def main(argv=None) -> dict:
    args = parse_args(argv)
    t_start = time.perf_counter()

    def stamp(msg):
        print(f"[{time.perf_counter() - t_start:7.1f}s] {msg}", flush=True)

    n = args.n
    print(f"device: {device_label(args.device)}; coronary {n}^3 radius="
          f"{max(6, n // 36)}; kernel backend", flush=True)
    spec = coronary_cube(n)
    live = live_cells(spec)
    stamp(f"geometry built: {n}^3, occupancy {live / n**3:.3f}")
    out = {"n": n, "live": live}
    if args.resume_only:
        resume_stage(spec, args, out)
        stamp("RESUME OK")
        return out

    sim = make_sim(spec, args.device, args.force_lowmem)
    stamp("sim constructed (lowmem)")
    s = float(chunk(sim, args.steps)[0].sum())
    stamp(f"{args.steps} steps done (incl. kernel build or load), velsum "
          f"{s:.4e}")
    _, elapsed = chunk(sim, args.steps)
    dt = elapsed / args.steps
    print(f"hot loop: {dt * 1e3:.2f} ms/step, {live / dt / 1e6:.0f} "
          f"MLUPS(live), {n**3 / dt / 1e6:.0f} MLUPS(box)", flush=True)
    out.update(velsum=s, ms_step=dt * 1e3, mlups_live=live / dt / 1e6,
               mlups_box=n**3 / dt / 1e6)

    t0 = time.perf_counter()
    umax = u_max(sim)
    sync(sim.device)
    print(f"macro (moments kernel): {time.perf_counter() - t0:.1f}s "
          f"on-device, |u|max {umax:.4f}", flush=True)
    if not (np.isfinite(umax) and umax > 0):
        raise RuntimeError(f"|u|max {umax}")
    out["u_max"] = umax

    w = wss_stats(sim)
    print(f"wss ({'live-cell' if sim._wss_via_sparse() else 'dense'} "
          f"stress route): {w['count']} wall-adjacent cells, mean "
          f"{w['mean_pa']:.3f} Pa, max {w['max_pa']:.3f} Pa in "
          f"{w['seconds']:.1f}s", flush=True)
    if not (np.isfinite(w["max_pa"]) and w["max_pa"] > 0):
        raise RuntimeError(f"wss max {w['max_pa']}")
    out["wss"] = w

    if not args.no_vtk:
        path, seconds = write_vtk(sim, args.out)
        size = os.path.getsize(path)
        print(f"VTK written: {path} ({size / 1e9:.2f} GB) in "
              f"{seconds:.1f}s", flush=True)
        out.update(vtk=path, vtk_bytes=size, vtk_s=seconds)

    if args.no_ckpt:
        stamp("REQUESTED OUTPUT SURFACES OK")
        return out
    cpath = os.path.join(args.out, CKPT_NAME)
    seconds = write_checkpoint(sim, cpath)
    size = os.path.getsize(cpath)
    print(f"checkpoint (uncompressed): {cpath} ({size / 1e9:.2f} GB) in "
          f"{seconds:.1f}s", flush=True)
    out.update(ckpt=cpath, ckpt_bytes=size, ckpt_s=seconds, t=sim.t)

    # free the run's state before the restored run allocates its own
    import torch

    del sim
    if torch.device(args.device).type == "cuda":
        torch.cuda.empty_cache()
    resume_stage(spec, args, out)
    stamp(f"ALL OUTPUT SURFACES OK at {n}^3")
    return out


if __name__ == "__main__":
    main()
