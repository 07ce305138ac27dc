"""Adjoint outlet-calibration demo (the port of lbm_tpu's
tools/demo_adjoint.py).

The synthetic coronary tree gets a velocity inlet and 4 RCR outlet
terminations, and the distal resistances Rd are chosen so the computed flow
split matches a per-branch target: gradient descent with the exact
discrete adjoint, torch.autograd through the checkpointed rollout
(engine/adjoint.py).

Stages:
  1. fit: Adam on log Rd, loss = ||split(rollout) - target||^2, one
     forward + backward per iterate on the dense step.
  2. verify: run the production Simulation (on CUDA the kernel route: the
     windkessel fold) with the fitted RCRs and measure the split with the
     clinical plane diagnostics: the fit must transfer out of the adjoint
     horizon (the split within 0.03 of the target).

Usage: python -m lbm_tpu_torch.tools.demo_adjoint [--shape 96,96,120
       --radius 7] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from lbm_tpu_torch.tools import device_label, sync

WK0 = [(1e-4, 5e3, 2e-3)] * 4          # uniform start: the wrong split


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="96,96,120")
    ap.add_argument("--radius", type=int, default=7)
    ap.add_argument("--target", default="0.40,0.27,0.20,0.13",
                    help="per-outlet flow-split target "
                    "(main, sub5, sub6, sub7)")
    ap.add_argument("--steps", type=int, default=600,
                    help="rollout horizon inside the loss")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--chunk", type=int, default=30,
                    help="remat chunk (peak memory ~ steps/chunk states + "
                    "one chunk's activations)")
    ap.add_argument("--verify-steps", type=int, default=4000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    return ap.parse_args(argv)


def fit_stage(args, shape, target):
    """Stage 1: (theta (4, 3), history) of fit_windkessel, with its
    timing and peak device memory printed."""
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.adjoint import fit_windkessel

    spec = get_case("coronary", shape=shape, radius=args.radius,
                    windkessel=WK0)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    theta, hist = fit_windkessel(spec, target, n_steps=args.steps,
                                 iters=args.iters, lr=args.lr,
                                 remat_chunk=args.chunk, verbose=True,
                                 device=args.device)
    sync(args.device)
    dt = time.perf_counter() - t0
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if cuda else "")
    print(f"fit: {args.iters} adjoint iterations ({args.steps}-step "
          f"rollouts) in {dt:.1f}s = {dt / args.iters:.1f} s/iter "
          f"(forward+backward){peak}", flush=True)
    print("fitted Rd:", " ".join(f"{r:.4e}" for r in theta[:, 2]))
    print(f"loss {hist[0][0]:.3e} -> {hist[-1][0]:.3e}", flush=True)
    return theta, hist


def verify_stage(args, shape, theta):
    """Stage 2: the converged split of a production Simulation on the
    fitted terminations."""
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.diagnostics import plane_flux
    from lbm_tpu_torch.engine.runner import Simulation

    spec_v = get_case("coronary", shape=shape, radius=args.radius,
                      windkessel=[tuple(map(float, row)) for row in theta])
    sim = Simulation(spec_v, device=args.device)
    t0 = time.perf_counter()
    sim.run(max_steps=args.verify_steps, time_save=args.verify_steps,
            verbose=False)
    _, u = (a.cpu().numpy() for a in sim.macro())
    idx = [k for k, b in enumerate(spec_v.boundaries)
           if b.windkessel is not None]
    q = np.asarray([plane_flux(spec_v, u, k) for k in idx])
    split = q / q.sum()
    print(f"verify: {sim.backend} Simulation, {args.verify_steps} steps in "
          f"{time.perf_counter() - t0:.1f}s")
    print(f"converged split: {' '.join(f'{s:.3f}' for s in split)}",
          flush=True)
    return split


def main(argv=None):
    args = parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split(","))
    target = np.asarray([float(s) for s in args.target.split(",")],
                        np.float32)
    assert abs(target.sum() - 1.0) < 1e-6, "target split must sum to 1"
    print(f"device: {device_label(args.device)}; case: coronary {shape} "
          f"radius={args.radius}, 4 RCR outlets, uniform Rd={WK0[0][2]:g} "
          "start")
    print(f"target split: {' '.join(f'{t:.3f}' for t in target)}",
          flush=True)
    theta, _ = fit_stage(args, shape, target)
    split = verify_stage(args, shape, theta)
    err = np.abs(split - target).max()
    print(f"max |split - target| = {err:.4f}")
    assert err < 0.03, "fitted terminations must hit the target split"
    print("OK")


if __name__ == "__main__":
    main()
