"""The 512^3 coronary tree split along y over --ndev ranks (the port of
lbm_tpu's tools/demo_512_sharded.py, its 8-device CPU-mesh emulation of
the scale-out row): gloo ranks spawned on this machine
(parallel/launch.spawn; on the card, ranks that share it, their halo
planes staged through pinned host memory), each stepping its window with
K1d over its fluid cells (Simulation(mesh=, backend='kernel',
shard_axis=1): lbm_collide_stream_halo_list, the z outlets' rows in the
same launch).

It prints each rank's listed lanes against its window's cells (the
counterpart of lbm_tpu's tile lists, "skip active": fewer lanes than
cells on every rank), each step's velsum summed over the ranks (the
fluid velsum, less the non-fluid offset, as lbm_tpu's step returns it),
each rank's ms/step and the exchange alone, and checks the dead-cell
contract without gathering the box: each rank holds its window's
f_standard() part (Simulation.window_standard) finite with zeros at
DEAD cells, and the ranks' flags are combined in rank order.
(f_standard() under a mesh would gather the whole 10.2 GB box on every
rank.)

The spec is built once, in the launching process, and handed to the
ranks as files: its box-sized arrays as .npy, which each rank maps
(np.load(mmap_mode='c')) and reads only its window's rows of, the rest
pickled. Host memory at 512^3: the spec (~2.8 GB) once, a window's
compile (~1 GB) a rank; device memory 2 x 1.27 GB a rank.

Usage: python -m lbm_tpu_torch.tools.demo_512_sharded [--n 512]
         [--steps 2] [--ndev 8] [--device cuda]
Smoke: --n 72 --ndev 2 --steps 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import tempfile
import time

import numpy as np

from lbm_tpu_torch.tools import coronary_cube, device_label

# CaseSpec fields of the box's size: written as .npy, mapped by the ranks
BOX_FIELDS = ("mask", "rho0", "u0", "wall_sdf")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--ndev", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the gloo ranks' device: cuda (ranks sharing the "
                    "card) or cpu (the plain versions)")
    return ap.parse_args(argv)


def save_spec(spec, spec_dir: str) -> None:
    """spec as files in spec_dir: BOX_FIELDS as .npy, the rest pickled."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec)}
    for name in BOX_FIELDS:
        if fields[name] is not None:
            np.save(os.path.join(spec_dir, f"{name}.npy"),
                    np.asarray(fields[name]))
            fields[name] = f"{name}.npy"
    with open(os.path.join(spec_dir, "spec.pkl"), "wb") as fh:
        pickle.dump(fields, fh)


def load_spec(spec_dir: str):
    """The CaseSpec save_spec wrote, its box-sized arrays mapped copy on
    write (a write stays in this process; torch takes them without a
    copy on the CPU)."""
    from lbm_tpu_torch.engine.spec import CaseSpec

    with open(os.path.join(spec_dir, "spec.pkl"), "rb") as fh:
        fields = pickle.load(fh)
    for name in BOX_FIELDS:
        if isinstance(fields[name], str):
            fields[name] = np.load(os.path.join(spec_dir, fields[name]),
                                   mmap_mode="c")
    return CaseSpec(**fields)


def window_rows_path(rows_dir: str, rank: int) -> str:
    return os.path.join(rows_dir, f"rows_{rank}.npy")


def sharded_rank(mesh, spec_dir: str, steps: int,
                 rows_dir: str | None = None) -> dict:
    """One rank: its window of the spec in spec_dir on the kernel route,
    `steps` steps one runner chunk each (counters reset just before and
    read just after), 10 rounds of the exchange alone, then the dead-cell
    contract on its window. rows_dir: where it writes its window's first
    and last y rows of window_standard() ((2, 19, X, Z) float32). Returns
    its numbers; every rank's carry the flags of all ranks in rank
    order."""
    import torch

    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.geometry.mask import CellType
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.parallel.halo import Exchange, edge_planes

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    t0 = time.perf_counter()
    spec = load_spec(spec_dir)
    sim = Simulation(spec, device=mesh.device.type, backend="kernel",
                     mesh=mesh, shard_axis=1)
    cc = sim.cc
    cells = int(np.prod(cc.shape))
    lanes = (cells if cc.fluid_cells is None
             else int(cc.fluid_launch.links.numel()))
    offset = float(mesh.sum_in_rank_order(np.asarray([cc.velsum_offset]))[0])
    setup_s = time.perf_counter() - t0

    mesh.barrier()
    K.reset_launches()
    velsum, step_ms = [], []
    for _ in range(steps):
        res = sim.run(max_steps=1, time_save=1, verbose=False)
        velsum.append(float(res.velsum_series[0]) - offset)
        step_ms.append(res.elapsed_s * 1e3)
    launches = dict(K.launches)

    swap = Exchange(mesh)
    planes = edge_planes(sim.f, sim.shard_axis)
    mesh.barrier()
    sync()
    t1 = time.perf_counter()
    for _ in range(10):
        swap(*planes)
    sync()
    exchange_ms = (time.perf_counter() - t1) / 10 * 1e3
    del planes

    # the dead-cell contract on this rank's part of f_standard()
    w = sim.window_standard()
    lo, hi = torch.aminmax(w, dim=0)
    top = torch.maximum(hi, -lo)
    finite = bool(torch.isfinite(top).all())
    dead_zero = not bool(top[cc.mask == CellType.DEAD].any())
    del lo, hi, top
    if rows_dir is not None:
        edge = torch.stack([w[:, :, 0], w[:, :, -1]]).cpu().numpy()
        np.save(window_rows_path(rows_dir, mesh.rank), edge)
    del w
    flags = mesh.all_gather(torch.tensor([[int(finite), int(dead_zero)]]))
    return {"rank": mesh.rank, "shape": tuple(cc.shape), "cells": cells,
            "lanes": lanes, "velsum": velsum, "step_ms": step_ms,
            "exchange_ms": exchange_ms, "launches": launches,
            "setup_s": setup_s, "flags": flags.tolist(),
            "rows": mesh.rank * cc.shape[1],
            "peak_gib": (torch.cuda.max_memory_allocated(mesh.device) / 2**30
                         if mesh.device.type == "cuda" else 0.0)}


def run_sharded(spec_dir: str, ndev: int, steps: int, device: str,
                timeout: float = 900.0, rows_dir: str | None = None) -> list:
    """The spec that save_spec wrote to spec_dir on ndev spawned gloo
    ranks (sharded_rank); the ranks' results in rank order. timeout:
    seconds for the whole spawn, after which every rank is killed."""
    import torch

    from lbm_tpu_torch.parallel.launch import spawn

    return spawn(sharded_rank, ndev, (spec_dir, steps, rows_dir),
                 device=torch.device(device).type, timeout=timeout,
                 store_dir=os.path.dirname(os.path.abspath(spec_dir)))


def report(ranks: list, n: int, ndev: int) -> dict:
    """Print the ranks' lines and check them: fewer listed lanes than
    window cells on every rank, finite velsums, every rank's window
    finite with zeros at DEAD cells. Returns the numbers printed."""
    lanes = [r["lanes"] for r in ranks]
    cells = ranks[0]["cells"]
    print(f"lane lists: {lanes} lanes of {cells} window cells a rank "
          f"(max {max(lanes) / cells:.1%} — skip active)", flush=True)
    if not max(lanes) < cells:
        raise RuntimeError(f"a rank lists every cell of its window: {lanes}")
    velsum = ranks[0]["velsum"]
    for t, v in enumerate(velsum):
        print(f"step {t}: velsum {v:.4e}", flush=True)
    if not np.isfinite(velsum).all():
        raise RuntimeError(f"velsum {velsum}")
    ms = [float(np.mean(r["step_ms"])) for r in ranks]
    ex = [r["exchange_ms"] for r in ranks]
    print("ms a step per rank, step by step "
          + str([[round(m, 3) for m in r["step_ms"]] for r in ranks])
          + ", the exchange alone " + str([round(e, 3) for e in ex])
          + f" ms ({max(ex) / max(ms):.1%} of the slowest mean step)",
          flush=True)
    flags = ranks[0]["flags"]
    if not all(f == [1, 1] for f in flags):
        raise RuntimeError(f"the dead-cell contract fails on a rank "
                           f"(finite, zeros at DEAD): {flags}")
    print(f"every window finite with zeros at DEAD cells ({ndev} ranks, "
          f"flags in rank order {flags}) — {n}^3 sharded x{ndev} OK",
          flush=True)
    return {"lanes": lanes, "cells": cells, "velsum": velsum, "ms": ms,
            "step_ms": [r["step_ms"] for r in ranks],
            "exchange_ms": ex, "flags": flags,
            "launches": [r["launches"] for r in ranks]}


def main(argv=None) -> dict:
    args = parse_args(argv)
    n = args.n
    t0 = time.perf_counter()

    def stamp(msg):
        print(f"[{time.perf_counter() - t0:7.1f}s] {msg}", flush=True)

    print(f"device: {device_label(args.device)}; coronary {n}^3 radius="
          f"{max(6, n // 36)} on y over {args.ndev} gloo ranks", flush=True)
    spec = coronary_cube(n)
    live = int((np.asarray(spec.mask) != 0).sum())
    stamp(f"geometry: {n}^3, occupancy {live / n**3:.4f}")
    with tempfile.TemporaryDirectory(prefix="demo512_sharded_") as tmp:
        spec_dir = os.path.join(tmp, "spec")
        os.mkdir(spec_dir)
        save_spec(spec, spec_dir)
        del spec
        ranks = run_sharded(spec_dir, args.ndev, args.steps, args.device)
    out = report(ranks, n, args.ndev)
    stamp(f"{n}^3 sharded x{args.ndev} on y, halo exchange: OK")
    return out


if __name__ == "__main__":
    main()
