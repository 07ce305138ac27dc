"""One step of each sharded path on n gloo CPU ranks (the counterpart of
paths 1-3 of lbm_tpu's __graft_entry__.dryrun_multichip):

  1. the dense halo step (parallel/halo.make_halo_step) on the lid
     cavity, split along x;
  2. the kernel route (parallel/sharded.make_sharded_step: K1d's plain
     version on the CPU) on the lid cavity, split along x;
  3. the kernel route on the coronary tree split along y, with its
     z-plane sub-outlets.

lbm_tpu's path 4 (windkessel outlets under a mesh on the dense backend,
ROADMAP.md Queue 1 item 1) and path 5 (the sharded scalar kernel,
ScalarTransportPallas(mesh=)) belong to later slices of the port.

    python -c "from lbm_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.parallel.launch import spawn


def _paths(mesh, n: int) -> list[str]:
    """The three paths on this rank; their names and checks."""
    done = []
    lid = get_case("lid_driven_cavity", n=n)
    cor = get_case("coronary", shape=(32, 16 * mesh.world, 32), radius=5)
    for label, spec, backend in (("dense halo step, lid", lid, "dense"),
                                 ("kernel route, lid", lid, "kernel"),
                                 ("kernel route, coronary on y", cor,
                                  "kernel")):
        sim = Simulation(spec, device="cpu", backend=backend, mesh=mesh)
        res = sim.run(max_steps=1, time_save=1, verbose=False)
        f = sim.f_standard()
        assert res.steps == 1 and tuple(f.shape) == (19,) + spec.shape
        assert bool(torch.isfinite(f).all()), label
        done.append(label)
    return done


def dryrun_multichip(n: int = 4, timeout: float = 60.0) -> list[str]:
    """Run the three paths on n gloo CPU ranks; the paths' names (raises
    if a rank fails or the run outlasts `timeout` seconds)."""
    size = max(16, 2 * n)
    out = spawn(_paths, n, (size,), backend="gloo", device="cpu",
                timeout=timeout, threads=1)
    return out[0]


__all__ = ["dryrun_multichip"]
