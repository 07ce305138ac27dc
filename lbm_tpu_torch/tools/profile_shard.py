"""What the sharded step costs on one rank beyond the unsharded one (the
port of lbm_tpu's tools/profile_shard.py), on lid_driven_cavity n^3:

  v1_unsharded : kernels.step over the whole case (K1a over the box,
                 lbm_collide_stream[bgk]), ping-pong
  v2_halokernel: K1d (lbm_collide_stream_halo, [bgk+halo]) on
                 compile_shard(spec, 0, 1, 0) called directly, its lo/hi
                 planes cut once from the initial state's own wrap edges:
                 wrong physics after the first step, the same kernel work,
                 no exchange and no edge_planes copies
  v3_noexch    : parallel/sharded.make_sharded_step with its Exchange
                 replaced by one that returns the planes it is given
  v4_sharded   : the production make_sharded_step on a one-rank gloo
                 group on the device

On one rank the port's Exchange returns its planes unchanged
(parallel/halo.py: a ring of one is its own neighbour), so v3 and v4 do
the same work: what separates v2 from v3/v4 is edge_planes' two copies a
step, and what separates v1 from v2 is K1d against K1a. Each variant is
a warm run of --steps steps and then a timed run that ends in a device
read of the velsum series' sum.

Usage: python -m lbm_tpu_torch.tools.profile_shard [--n 256] [--steps 100]
         [--variants v1,v2,v3,v4] [--device cuda]
Smoke: --n 16 --steps 4 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import numpy as np

from lbm_tpu_torch.tools import device_label

NAMES = {"v1": "v1_unsharded", "v2": "v2_halokernel", "v3": "v3_noexch",
         "v4": "v4_sharded"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--variants", default="v1,v2,v3,v4")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    return ap.parse_args(argv)


def time_scan(step, f, steps: int) -> float:
    """Seconds a step of `steps` steps of step(f, out, series, slot, t)
    from the state f (ping-pong with a copy of it), after a warm run of
    the same length; each run ends in a device read of the velsum
    series' sum."""
    import torch

    out = f.clone()
    series = torch.zeros(steps, dtype=torch.float64, device=f.device)

    def run(f, out, t0):
        for k in range(steps):
            step(f, out, series, k, t0 + k)
            f, out = out, f
        float(series.sum())
        return f, out

    f, out = run(f, out, 0)
    t0 = time.perf_counter()
    run(f, out, steps)
    return (time.perf_counter() - t0) / steps


@contextlib.contextmanager
def one_rank_group(device):
    """A LatticeMesh of one gloo rank on `device`'s type: the running
    group's if one is up (it must have one rank), else one made from a
    FileStore here and destroyed after."""
    import torch
    import torch.distributed as dist

    from lbm_tpu_torch.parallel.mesh import lattice_mesh

    kind = torch.device(device).type
    if dist.is_initialized():
        yield lattice_mesh(1, device=kind)
        return
    with tempfile.TemporaryDirectory(prefix="profile_shard_") as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        mesh = lattice_mesh(1, "gloo", kind, rank=0, store=store)
        try:
            yield mesh
        finally:
            dist.destroy_process_group()


def variants(n: int, device, want: set, steps: int,
             hook=None) -> dict:
    """{variant name: seconds a step} of the variants in `want`. hook(name,
    step, f): called after each variant's timing with its step function
    and a fresh initial state (the counters and a profile of the card
    run)."""
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.compile import compile_case, compile_shard
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.parallel import sharded
    from lbm_tpu_torch.parallel.halo import edge_planes

    spec = get_case("lid_driven_cavity", n=n)
    results = {}

    def timed(key, step, make_f):
        results[NAMES[key]] = time_scan(step, make_f(), steps)
        if hook is not None:
            hook(NAMES[key], step, make_f())

    if "v1" in want:
        cc = compile_case(spec, device)
        timed("v1", lambda f, out, s, k, t: K.step(f, out, cc, s, k, t),
              lambda: initial_f(cc))
        del cc
    if not want & {"v2", "v3", "v4"}:
        return results
    sc = compile_shard(spec, 0, 1, 0, device)
    if "v2" in want:
        lo, hi = (p.clone() for p in edge_planes(initial_f(sc), 0))
        halo = sc.halo(lo, hi)
        timed("v2", lambda f, out, s, k, t: K.step(f, out, sc, s, k, t,
                                                   halo=halo),
              lambda: initial_f(sc))
    if want & {"v3", "v4"}:
        with one_rank_group(device) as mesh:
            if "v3" in want:
                orig = sharded.Exchange
                try:
                    sharded.Exchange = lambda mesh: (lambda lo, hi: (lo, hi))
                    step3 = sharded.make_sharded_step(sc, mesh, 0)
                finally:
                    sharded.Exchange = orig
                timed("v3", step3, lambda: initial_f(sc))
            if "v4" in want:
                timed("v4", sharded.make_sharded_step(sc, mesh, 0),
                      lambda: initial_f(sc))
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)
    want = set(args.variants.split(","))
    n3 = args.n ** 3
    print(f"device: {device_label(args.device)}; lid_driven_cavity "
          f"{args.n}^3, {args.steps} steps a run", flush=True)
    results = variants(args.n, args.device, want, args.steps)
    out = {}
    for name, dt in results.items():
        print(f"{name}: {dt * 1e3:.2f} ms/step, {n3 / dt / 1e6:.0f} MLUPS",
              flush=True)
        out[name] = {"ms": dt * 1e3, "mlups": n3 / dt / 1e6}
    if not all(np.isfinite(v["ms"]) and v["ms"] > 0 for v in out.values()):
        raise RuntimeError(f"a variant's time is not positive: {out}")
    return out


if __name__ == "__main__":
    main()
