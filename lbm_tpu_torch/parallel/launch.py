"""Start the ranks of a sharded run as processes of this machine.

    results = spawn(fn, world, args, backend="gloo", device="cpu")

runs fn(mesh, *args) on `world` spawned processes (gloo ranks on the
machine's cards unless device="cpu" asks for the CPU), each joined to one
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
the launch counters). run_transport is another: one ScalarTransport,
CoupledTransport or BuoyantTransport under the mesh (Gate is a bolus
that crosses by pickle).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional


def _rank_main(rank: int, world: int, backend: str, device: str,
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
          device: str = "cuda", timeout: Optional[float] = None,
          threads: Optional[int] = None,
          store_dir: Optional[str] = None) -> list[Any]:
    """fn(mesh, *args) on `world` ranks; their results in rank order.
    device: the gloo ranks' device, 'cuda' (the default; a rank raises
    without a card) or 'cpu'. timeout: seconds for the whole call (None:
    no limit), after which
    every rank is killed; threads: torch threads a rank (default: CPU
    ranks share the machine's cores, CUDA ranks keep torch's default);
    store_dir: where the FileStore's directory is made (default: the
    system's temporary directory). Each rank's process group bounds one
    wait by mesh.TIMEOUT_S."""
    if threads is None and backend == "gloo" and device == "cpu":
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
    "steps", "t", "launches": the kernel counters of the run, "wk": the
    windkessel P_c (None without outlets)}; the others {"wk": theirs}."""
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
    wk = None if sim.wk is None else sim.wk.cpu().numpy()
    if mesh.rank != 0:
        return {"wk": wk}
    return {"f": f, "velsum": res.velsum_series,
            "residuals": res.residual_history, "steps": res.steps,
            "t": sim.t, "launches": launches, "wk": wk}


def run_many(mesh, calls: list) -> list:
    """fn(mesh, *args) for each (fn, args) of `calls` in turn on this
    rank, their results in order: several runs in one spawn (a spawn's
    processes take seconds to start)."""
    return [fn(mesh, *args) for fn, args in calls]


@dataclasses.dataclass(frozen=True)
class Gate:
    """A bolus gate an inlet_c takes, picklable: c* = value for steps t <
    until, 0 after."""

    until: int
    value: float = 1.0

    def __call__(self, t: int) -> float:
        return self.value if t < self.until else 0.0


def transport_setup(setup: tuple):
    """(spec, keywords) of setup = ("case", name, opts): get_case(name,
    **opts) and no keywords, or ("thermal", name, opts): the thermal case
    function cases.thermal.<name>(**opts)'s spec and keywords."""
    kind, name, opts = setup
    if kind == "thermal":
        from lbm_tpu_torch.cases import thermal

        spec, kw, _ = getattr(thermal, name)(**opts)
        return spec, kw
    if kind != "case":
        raise ValueError(f"setup kind must be 'case' or 'thermal': {kind!r}")
    from lbm_tpu_torch.cases import get_case

    return get_case(name, **opts), {}


def run_transport(mesh, setup: tuple, transport: str, kw: dict, steps: int,
                  record: Optional[list] = None, u=None,
                  record_energy: bool = False, save: Optional[str] = None,
                  nusselt: Optional[dict] = None) -> dict:
    """transport ('scalar', 'coupled' or 'buoyant': ScalarTransport,
    CoupledTransport, BuoyantTransport) of transport_setup(setup) with
    keywords kw on this rank of `mesh` (on the mesh's device type),
    `steps` steps with the scalar kernel's counters reset just before and
    read just after. u: the frozen velocity of 'scalar', an array or the
    path of a .npy file. Every rank returns {"wk": its P_c or None,
    "launches", "ms": its ms a step (host clock, synchronized)}; rank 0
    adds the gathered "g", "c" (concentration()), "total", "series" (the
    records, None without `record`), "energy" (None without
    record_energy) and, coupled, "f" and "u" (macro()), as NumPy. A
    BuoyantTransport also saves a checkpoint to `save` and returns
    nusselt_profile(**nusselt) as "nusselt", when given."""
    import numpy as np
    import torch

    from lbm_tpu_torch.engine.scalar import CoupledTransport, ScalarTransport
    from lbm_tpu_torch.engine.thermal import BuoyantTransport
    from lbm_tpu_torch.kernels import scalar_stream as S

    spec, base = transport_setup(setup)
    kw = {**base, **kw}
    where = dict(device=mesh.device.type, mesh=mesh)
    if transport == "scalar":
        if isinstance(u, str):
            u = np.load(u)
        tr = ScalarTransport(spec, u, **kw, **where)
    elif transport == "coupled":
        tr = CoupledTransport(spec, **kw, **where)
    elif transport == "buoyant":
        tr = BuoyantTransport(spec, **kw, **where)
    else:
        raise ValueError(f"unknown transport {transport!r}")

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    mesh.barrier()
    S.reset_launches()
    sync()
    t0 = time.perf_counter()
    if transport == "buoyant":
        energy = tr.run(steps, record_energy=record_energy)
        series = None
    else:
        series = tr.run(steps, record=record)
        energy = None
    sync()
    ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
    out = {"wk": None if getattr(tr, "wk", None) is None
           else tr.wk.cpu().numpy(),
           "launches": dict(S.launches), "ms": ms}
    g, c, total = tr.g.cpu().numpy(), tr.concentration().cpu().numpy(), \
        tr.total()
    flow = nu = None
    if transport != "scalar":
        flow = (tr.f.cpu().numpy(), tr.macro()[1].cpu().numpy())
    if save is not None:
        tr.save(save)
    if nusselt is not None:
        nu = tr.nusselt_profile(**nusselt)
    if mesh.rank == 0:
        out.update(g=g, c=c, total=total, series=series, energy=energy,
                   nusselt=nu)
        if flow is not None:
            out.update(f=flow[0], u=flow[1])
    return out


__all__ = ["spawn", "run_case", "run_many", "run_transport", "transport_setup", "Gate"]
