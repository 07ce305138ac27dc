"""One step of each sharded path on n gloo CPU ranks (the counterpart of
paths 1-5 of lbm_tpu's __graft_entry__.dryrun_multichip):

  1. the dense halo step (parallel/halo.make_halo_step) on the lid
     cavity, split along x;
  2. the kernel route (parallel/sharded.make_sharded_step: K1d's plain
     version on the CPU) on the lid cavity, split along x;
  3. the kernel route on the coronary tree split along y, with its
     z-plane sub-outlets;
  4. the dense halo step with a windkessel (RCR) outlet (poiseuille,
     windkessel=(5e-4, 24000.0, 2.5e-3)): the outlet's flux summed
     across the ranks, P_c replicated;
  5. the sharded scalar kernel route (ScalarTransport(mesh=,
     backend='kernel'): K7's plain version on each rank's halo-row block)
     on the lid cavity at rest, D=0.05, c = 1 at boundary 0, 2 steps
     recording it.

    python -c "from lbm_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import torch

import numpy as np

from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.engine.scalar import ScalarTransport
from lbm_tpu_torch.parallel.launch import spawn


def _paths(mesh, n: int) -> list[str]:
    """The five paths on this rank; their names and checks."""
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
    label = "dense halo step with a windkessel outlet, poiseuille"
    sim = Simulation(get_case("poiseuille", n=n,
                              windkessel=(5e-4, 24000.0, 2.5e-3)),
                     device="cpu", backend="dense", mesh=mesh)
    wk = sim.wk.clone()
    sim.run(max_steps=1, time_save=1, verbose=False)
    assert sim.wk.shape == wk.shape and bool(torch.isfinite(sim.wk).all())
    assert bool(torch.isfinite(sim.f_standard()).all()), label
    done.append(label)
    label = "sharded scalar kernel route, lid"
    st = ScalarTransport(lid, np.zeros((3,) + lid.shape, np.float32),
                         D=0.05, inlet_c={0: 1.0}, device="cpu",
                         backend="kernel", mesh=mesh)
    series = st.run(2, record=[0])
    assert np.isfinite(series).all() and series.shape == (2, 1), label
    assert bool(torch.isfinite(st.concentration()).all()), label
    done.append(label)
    return done


def dryrun_multichip(n: int = 4, timeout: float = 60.0) -> list[str]:
    """Run the five paths on n gloo CPU ranks; the paths' names (raises
    if a rank fails or the run outlasts `timeout` seconds)."""
    size = max(16, 2 * n)
    out = spawn(_paths, n, (size,), backend="gloo", device="cpu",
                timeout=timeout, threads=1)
    return out[0]


__all__ = ["dryrun_multichip"]
