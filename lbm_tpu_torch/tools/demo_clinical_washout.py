"""Clinical pulsatile contrast washout (the port of lbm_tpu's
tools/demo_clinical_washout.py): the 291x291x372 synthetic coronary tree
with a systole/diastole series inlet, four RCR windkessel outlet
terminations, and a time-gated contrast bolus advecting in the live
pulsatile velocity, stepped by engine/scalar.CoupledTransport(backend=
'kernel') (lbm_tpu's CoupledTransportPallas): the windkessel fold and the
coupled D3Q7 kernel K8, P_c carried on the device.

Usage: python -m lbm_tpu_torch.tools.demo_clinical_washout
         [--shape 291,291,372] [--radius 10] [--spinup 2000] [--steps 6000]
         [--bolus 1500] [--device cuda]
Smoke: --shape 48,24,40 --radius 5 --spinup 40 --steps 80 --bolus 20
       --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from lbm_tpu_torch.tools import device_label, sync


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="291,291,372")
    ap.add_argument("--radius", type=int, default=10)
    ap.add_argument("--spinup", type=int, default=2000,
                    help="coupled steps before the bolus opens (flow "
                    "develops; scalar stays zero)")
    ap.add_argument("--steps", type=int, default=6000,
                    help="recorded washout steps after spin-up")
    ap.add_argument("--bolus", type=int, default=1500,
                    help="bolus gate length in steps (inlet c=1 while "
                    "spinup <= t < spinup + bolus, 0 after)")
    ap.add_argument("--period", type=int, default=2000,
                    help="cardiac period in steps (series stride = "
                    "period / 40 phases)")
    ap.add_argument("--tau_g", type=float, default=0.6)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.scalar import CoupledTransport

    shape = tuple(int(s) for s in args.shape.split(","))
    wk = [(2e-4, 2e4, 1e-3)] + [(2e-4, 2e4, 3e-3)] * 3
    spec = get_case("coronary", shape=shape, radius=args.radius,
                    windkessel=wk, pulsatile=(40, args.period))
    print(f"device: {device_label(args.device)}; case: coronary {shape} "
          f"radius={args.radius} pulsatile period={args.period} + 4 RCR "
          f"outlets + coupled transport (tau_g={args.tau_g})", flush=True)

    t_gate = args.spinup + args.bolus
    bolus = {0: lambda t: 1.0 if args.spinup <= t < t_gate else 0.0}
    rec = [0, 1, 2, 3, 4]   # boundaries: inlet, main, sub5, sub6, sub7
    names = ["inlet", "main", "sub5", "sub6", "sub7"]
    t0 = time.perf_counter()
    ct = CoupledTransport(spec, tau_g=args.tau_g, inlet_c=bolus,
                          device=args.device, backend="kernel")
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)

    # spin-up (kernel build or load + flow development; bolus gated off)
    t0 = time.perf_counter()
    first = min(args.chunk, args.spinup)
    ct.run(first, record=rec)
    print(f"warmup: first chunk (kernel build/load) "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    left = args.spinup - first
    t0 = time.perf_counter()
    while left > 0:
        n = min(args.chunk, left)
        ct.run(n, record=rec)
        left -= n
    if args.spinup > args.chunk:
        dt = time.perf_counter() - t0
        n_done = args.spinup - first
        print(f"spinup: {n_done} steps in {dt:.1f}s = "
              f"{dt / n_done * 1e3:.2f} ms/step", flush=True)

    series = []
    t0 = time.perf_counter()
    left = args.steps
    while left > 0:
        n = min(args.chunk, left)
        series.append(ct.run(n, record=rec))
        left -= n
    sync(args.device)
    dt = time.perf_counter() - t0
    series = np.concatenate(series, axis=0)  # (steps, 5)
    ncell = int(np.prod(shape))
    print(f"washout: {args.steps} steps in {dt:.1f}s = "
          f"{dt / args.steps * 1e3:.2f} ms/step "
          f"({ncell * args.steps / dt / 1e6:.1f} MLUPS box-convention, "
          f"flow+transport per step)", flush=True)

    pk = series.max(axis=0)
    tpk = series.argmax(axis=0)
    print(f"bolus: inlet gate {args.bolus} steps; plane curves "
          f"(sub-outlet transit is slow: branch u ~ Q/(pi r^2) is ~1e-2 "
          f"lattice, arrival takes O(50k) steps at rest):")
    for k, nm in enumerate(names):
        print(f"  {nm}: peak c {pk[k]:.3f} at step {tpk[k]}, "
              f"final c {series[-1, k]:.4f}")
    pc = ct.wk.cpu().numpy()
    print(f"windkessel P_c (lattice): {pc}")
    print(f"scalar total (conservation audit): {ct.total():.3f}")
    assert np.isfinite(series).all() and np.isfinite(pc).all()
    assert pk[:2].max() > 1e-2, "bolus never entered the tree"
    print("OK", flush=True)


if __name__ == "__main__":
    main()
