"""Contrast washout and residence time on the coronary tree (the port of
lbm_tpu's tools/demo_washout.py).

Inject a contrast bolus at the inlet of the converged coronary flow and
track each outlet's concentration curve (arrival, peak, washout half
time), then switch the source on (mean-age mode) and map the residence
time field. Both run on the frozen converged velocity with the D3Q7
transport (engine/scalar.ScalarTransport): backend 'kernel' is the CUDA
kernel K7 (lbm_tpu's ScalarTransportPallas), 'dense' the dense pass.

Usage: python -m lbm_tpu_torch.tools.demo_washout [--shape 96,96,120
       --radius 7] [--vtk out.vtk] [--device cuda]
"""

import argparse
import os
import time

import numpy as np

from lbm_tpu_torch.tools import device_label, sync


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="96,96,120")
    ap.add_argument("--radius", type=int, default=7)
    ap.add_argument("--flow-steps", type=int, default=4000)
    ap.add_argument("--bolus", type=int, default=400,
                    help="inlet gate length (steps)")
    ap.add_argument("--steps", type=int, default=12000,
                    help="transport steps per stage (must cover the "
                    "slowest branch's transit: the distal outlet on the "
                    "default tree peaks near step 6000)")
    ap.add_argument("--D", type=float, default=0.02,
                    help="lattice diffusivity")
    ap.add_argument("--backend", default="kernel",
                    choices=("kernel", "dense"),
                    help="transport backend (the D3Q7 CUDA kernel or the "
                    "dense pass)")
    ap.add_argument("--vtk", default=None,
                    help="write AGE + CONTRAST fields here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.scalar import ScalarTransport

    shape = tuple(int(s) for s in args.shape.split(","))
    spec = get_case("coronary", shape=shape, radius=args.radius)
    outlets = list(range(1, len(spec.boundaries)))
    print(f"device: {device_label(args.device)}; coronary {shape} "
          f"radius={args.radius}; {len(outlets)} outlets; D={args.D}; "
          f"transport backend {args.backend}", flush=True)

    t0 = time.perf_counter()
    sim = Simulation(spec, device=args.device)
    res = sim.run(max_steps=args.flow_steps, time_save=500, verbose=False)
    _, u = sim.macro()
    print(f"flow: {sim.t} steps in {time.perf_counter() - t0:.1f}s "
          f"(residual {res.residual:.2e})", flush=True)

    # stage 1: bolus washout curves per outlet
    tb = args.bolus
    st = ScalarTransport(spec, u, D=args.D,
                         inlet_c={0: lambda t: 1.0 if t < tb else 0.0},
                         device=args.device, backend=args.backend)
    t0 = time.perf_counter()
    series = st.run(args.steps, record=outlets)
    sync(args.device)
    dt = time.perf_counter() - t0
    print(f"bolus: {args.steps} transport steps in {dt:.1f}s = "
          f"{dt / args.steps * 1e3:.2f} ms/step")
    ct = spec.units.C_T
    for j, k in enumerate(outlets):
        cur = series[:, j]
        peak = float(cur.max())
        tp = int(cur.argmax())
        arr = int(np.argmax(cur > 0.05 * peak)) if peak > 0 else -1
        below = np.nonzero(cur[tp:] < 0.5 * peak)[0]
        half = tp + int(below[0]) if len(below) else None
        t12 = (f"{half} ({half * ct * 1e3:.1f} ms)" if half is not None
               else f"beyond horizon (c[end] = {cur[-1]:.3f})")
        print(f"  outlet {k}: arrival {arr} steps ({arr * ct * 1e3:.1f} ms)"
              f", peak {peak:.3f} @ {tp}, washout t1/2 {t12}", flush=True)
        # slow distal branches dilute a short bolus heavily, so the
        # arrival criterion is absolute but small
        assert peak > 1e-3, "bolus must reach every outlet"
    assert np.isfinite(series).all()

    # stage 2: mean-age (residence time) field
    st2 = ScalarTransport(spec, u, D=args.D, inlet_c={0: 0.0}, source=1.0,
                          device=args.device, backend=args.backend)
    t0 = time.perf_counter()
    st2.run(args.steps)
    age = st2.concentration().cpu().numpy()
    a = age[st2.fluid.cpu().numpy()]
    print(f"age: {args.steps} steps in {time.perf_counter() - t0:.1f}s; "
          f"mean {a.mean() * ct * 1e3:.1f} ms, p95 "
          f"{np.percentile(a, 95) * ct * 1e3:.1f} ms, max "
          f"{a.max() * ct * 1e3:.1f} ms (stasis pockets)")
    assert np.isfinite(a).all() and a.min() >= 0

    if args.vtk:
        from lbm_tpu_torch.io.vtk import write_structured_points

        write_structured_points(
            args.vtk,
            {"AGE_s": age * ct,
             "CONTRAST": st.concentration().cpu().numpy()},
            spacing=spec.units.CH, origin=(0.0, 0.0, 0.0),
            crops=spec.vtk_crops, binary=True,
            header="lbm_tpu_torch washout/residence-time demo")
        print(f"vtk: {args.vtk} ({os.path.getsize(args.vtk) / 1e6:.1f} MB)")
    print("OK")


if __name__ == "__main__":
    main()
