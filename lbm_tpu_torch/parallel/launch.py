"""Start the ranks of a sharded run as processes of this machine.

    results = spawn(fn, world, args, backend="gloo", device="cpu")

runs fn(mesh, *args) on `world` spawned processes, each joined to one
torch.distributed group through a FileStore in a fresh temporary
directory (no port to pick), and returns the ranks' return values in
rank order. fn and its arguments and results cross by pickle: fn is a
module-level function. A rank that raises fails the whole call, and a
`timeout` bounds it: then every rank still running is killed and
RuntimeError names what happened, so a rank that stopped early never
leaves the others hanging in an exchange.

run_case is such an fn: one case through Simulation(mesh=), optionally
resumed from or saved to a checkpoint, with rank 0 returning what a
caller compares (the gathered state, the velsum series, the residuals,
the launch counters).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional


def _rank_main(rank: int, world: int, backend: str, device: Optional[str],
               store_path: str, threads: Optional[int], fn: Callable,
               args: tuple, results) -> None:
    import torch
    import torch.distributed as dist

    from lbm_tpu_torch.parallel.mesh import lattice_mesh

    if threads:
        torch.set_num_threads(threads)
    try:
        store = dist.FileStore(store_path, world)
        mesh = lattice_mesh(world, backend, device, rank=rank, store=store)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
          device: Optional[str] = None, timeout: Optional[float] = None,
          threads: Optional[int] = None,
          store_dir: Optional[str] = None) -> list[Any]:
    """fn(mesh, *args) on `world` ranks; their results in rank order.
    timeout: seconds for the whole call (None: no limit), after which
    every rank is killed; threads: torch threads a rank (default: CPU
    ranks share the machine's cores, CUDA ranks keep torch's default);
    store_dir: where the FileStore's directory is made (default: the
    system's temporary directory). Each rank's process group bounds one
    wait by mesh.TIMEOUT_S."""
    if threads is None and backend == "gloo" and (device or "cpu") == "cpu":
        threads = max(1, (os.cpu_count() or 1) // world)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lbm_tpu_torch_store_", dir=store_dir)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, backend, device, f"{tmp}/store", threads, fn, args,
        results)) for r in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    got: dict[int, Any] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        while len(got) < world and failure is None:
            if deadline is not None and time.monotonic() > deadline:
                failure = (f"{world} ranks did not finish within {timeout} s "
                           f"({len(got)} did)")
                break
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    failure = f"a rank exited with code {dead[0]}"
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
        for p in procs:
            left = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            p.join(left if failure is None else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"sharded run failed: {failure}")
    return [got[r] for r in range(world)]


def run_case(mesh, case: str, opts: dict, backend: str = "kernel",
             steps: int = 4, time_save: int = 2,
             resume: Optional[str] = None,
             save: Optional[str] = None) -> Optional[dict]:
    """get_case(case, **opts) stepped `steps` steps in chunks of
    time_save on this rank of `mesh` (on the mesh's device type),
    restored from the checkpoint `resume` first and saved to `save`
    after, when given. Rank 0 returns {"f": f_standard() as NumPy,
    "velsum": the velsum series (None for 'usq' cases), "residuals",
    "steps", "t", "launches": the kernel counters of the run}; the
    others None."""
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine import checkpoint
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as kernels

    sim = Simulation(get_case(case, **opts), device=mesh.device.type,
                     backend=backend, mesh=mesh)
    if resume is not None:
        checkpoint.restore(sim, resume)
    kernels.reset_launches()
    res = sim.run(max_steps=steps, time_save=time_save, verbose=False)
    launches = dict(kernels.launches)
    if save is not None:
        checkpoint.save_sim(save, sim)
    f = sim.f_standard().cpu().numpy()
    if mesh.rank != 0:
        return None
    return {"f": f, "velsum": res.velsum_series,
            "residuals": res.residual_history, "steps": res.steps,
            "t": sim.t, "launches": launches}


__all__ = ["spawn", "run_case"]
