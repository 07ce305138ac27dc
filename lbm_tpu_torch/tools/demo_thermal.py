"""Boussinesq natural convection: the de Vahl Davis heated cavity
(engine/thermal.BuoyantTransport on the dense route, lbm_tpu's dense
BuoyantTransport) at a chosen size and Rayleigh number (the port of
lbm_tpu's tools/demo_thermal.py). Prints the converged mean Nusselt
number against the benchmark and the ms/step of the coupled flow +
temperature step.

Usage: python -m lbm_tpu_torch.tools.demo_thermal [--n 26] [--ny 1]
       [--ra 1e3] [--tau 0.66] [--chunks 6 --steps 5000] [--device cuda]
"""

import argparse
import os
import time

import numpy as np

from lbm_tpu_torch.tools import device_label

BENCH = {1e3: 1.118, 1e4: 2.243, 1e5: 4.519}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=26)
    ap.add_argument("--ny", type=int, default=1,
                    help="spanwise depth (1 = exact 2D dynamics; >1 "
                    "exercises the full 3D box)")
    ap.add_argument("--ra", type=float, default=1e3)
    ap.add_argument("--pr", type=float, default=0.71)
    ap.add_argument("--tau", type=float, default=0.66)
    ap.add_argument("--steps", type=int, default=5000,
                    help="steps per chunk")
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--vtk", default=None,
                    help="write TEMPERATURE + VELOCITY fields here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs on the host)")
    args = ap.parse_args(argv)

    from lbm_tpu_torch.cases.thermal import heated_cavity
    from lbm_tpu_torch.engine.thermal import BuoyantTransport

    spec, kw, info = heated_cavity(n=args.n, ny=args.ny, ra=args.ra,
                                   pr=args.pr, tau=args.tau)
    print(f"device: {device_label(args.device)}; cavity "
          f"{args.n}x{args.ny}x{args.n}; Ra={args.ra:g} Pr={args.pr} "
          f"nu={info['nu']:.4f} kappa={info['kappa']:.4f} "
          f"buoyancy={info['b']:.3e}", flush=True)

    bt = BuoyantTransport(spec, device=args.device, backend="dense", **kw)
    e = bt.run(args.steps, record_energy=True)    # warm
    t0 = time.time()
    for _ in range(args.chunks - 1):
        e = bt.run(args.steps, record_energy=True)
    dt = time.time() - t0         # the energy series is read at each chunk
    n_steps = args.steps * (args.chunks - 1)
    ms = 1e3 * dt / max(n_steps, 1)
    drift = abs(float(e[-1]) - float(e[0])) / max(abs(float(e[0])), 1e-30)
    _, nu = bt.nusselt_profile(hot_axis=0, kappa=info["kappa"],
                               dT=info["dT"], H=info["H"])
    ref = BENCH.get(args.ra)
    ref_s = (f" (de Vahl Davis {ref}; err "
             f"{abs(nu.mean() - ref) / ref * 100:.1f}%)" if ref else "")
    print(f"steady: last-chunk energy drift {drift:.2e}; "
          f"Nu profile [{nu.min():.4f}, {nu.max():.4f}] "
          f"plane-spread {(nu.max() - nu.min()) / nu.mean() * 100:.2f}%")
    print(f"Nu = {nu.mean():.4f}{ref_s}")
    print(f"{ms:.3f} ms per coupled flow+temperature step "
          f"({n_steps} steps warm, {dt:.1f} s)", flush=True)
    assert np.isfinite(nu).all()

    if args.vtk:
        from lbm_tpu_torch.io.vtk import write_structured_points

        _, u = bt.macro()
        write_structured_points(
            args.vtk,
            {"TEMPERATURE": bt.concentration().cpu().numpy(),
             "VELOCITY": u.cpu().numpy()},
            spacing=1.0, origin=(0.0, 0.0, 0.0), binary=True,
            header="lbm_tpu_torch Boussinesq heated-cavity demo")
        print(f"vtk: {args.vtk} ({os.path.getsize(args.vtk) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
