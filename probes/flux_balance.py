#!/usr/bin/env python3
"""Mass balance of the small windkessel coronary over one pulse period:
the inlet's and the four RCR outlets' plane fluxes (engine/diagnostics
plane_flux on macro()'s velocity, outward positive) and the fluid cells'
total mass (sum of macro()'s rho) after every step, on lbm_tpu's 'xla'
and 'sparse' backends and the port's 'dense', 'sparse' and 'kernel'
backends. Prints, for each route, the period's mean fluxes, the mean
net inflow (inlet in minus the outlets' out), the mean mass change a
step and what neither accounts for; writes each route's per-step log as
CSV into OUT (default: a temporary directory).

    python3 probes/flux_balance.py [--period 2000] [--out DIR]
        [--routes xla,sparse,dense,torch_sparse,torch_kernel]
        [--device cpu|cuda] [--full]

lbm_tpu's routes need jax and lbm_tpu beside lbm_tpu_torch (the CPU test
environment) and run on the CPU. The port's run on --device: on a CUDA
card the fields stay there, and only each boundary's plane and the mass
sum are read to the host a step. --full: the full clinical coronary
(291, 291, 372) r=12, the port's routes only (31.5 M cells):

    python3 probes/flux_balance.py --device cuda --full \
        --routes torch_kernel,dense,torch_sparse
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

# the clinical run's RCR triples (tools/demo_clinical_washout.py:64-66)
WK_CLIN = [(2e-4, 2e4, 1e-3)] + [(2e-4, 2e4, 3e-3)] * 3


def _spec_kw(period: int, full: bool = False) -> dict:
    if full:
        return dict(shape=(291, 291, 372), radius=12, windkessel=WK_CLIN,
                    pulsatile=(40, period))
    return dict(shape=(48, 24, 40), radius=5, windkessel=WK_CLIN,
                pulsatile=(40, period))


def _balance(spec, log: np.ndarray) -> dict:
    """log rows: step, flux of each boundary (outward +), fluid mass."""
    nb = len(spec.boundaries)
    flux = log[:, 1:1 + nb]
    mass = log[:, 1 + nb]
    inflow = -flux[:, 0]                       # the inlet, inward
    out = flux[:, 1:].sum(axis=1)
    dm = np.diff(mass)
    return {"mean_in": inflow.mean(), "mean_out_each": flux[:, 1:].mean(0),
            "mean_out": out.mean(), "mean_net": (inflow - out)[1:].mean(),
            "mean_dmass": dm.mean(),
            "unaccounted": ((inflow - out)[1:] - dm).mean(),
            "mass0": mass[0], "mass_end": mass[-1]}


def run_lbm_tpu(backend: str, period: int) -> tuple:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from lbm_tpu.cases import get_case
    from lbm_tpu.engine.diagnostics import plane_flux
    from lbm_tpu.engine.runner import Simulation

    spec = get_case("coronary", **_spec_kw(period))
    sim = Simulation(spec, backend=backend)
    fluid = np.asarray(spec.mask) == 4
    rows = []

    def record():
        rho, u = sim.macro()
        u = np.asarray(u)
        rows.append([sim.t] + [plane_flux(spec, u, b)
                               for b in range(len(spec.boundaries))]
                    + [float(np.asarray(rho)[fluid].sum(dtype=np.float64))])

    record()
    for _ in range(period):
        sim.run(max_steps=1, time_save=1, verbose=False)
        record()
    return spec, np.asarray(rows)


def run_port(backend: str, period: int, device: str = "cpu",
             full: bool = False) -> tuple:
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.diagnostics import plane_flux
    from lbm_tpu_torch.engine.runner import Simulation

    spec = get_case("coronary", **_spec_kw(period, full))
    sim = Simulation(spec, device=device, backend=backend)
    fluid = torch.from_numpy(np.asarray(spec.mask) == 4).to(sim.device)
    rows = []

    def record():
        rho, u = sim.macro()
        mass = torch.where(fluid, rho, 0.0).sum(dtype=torch.float64)
        rows.append([sim.t] + [plane_flux(spec, u, b)
                               for b in range(len(spec.boundaries))]
                    + [float(mass)])

    record()
    for _ in range(period):
        sim._advance(1)
        record()
    return spec, np.asarray(rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--period", type=int, default=2000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--routes", default="xla,sparse,dense,torch_sparse")
    ap.add_argument("--device", default="cpu",
                    help="the port's device (lbm_tpu's routes: the CPU)")
    ap.add_argument("--full", action="store_true",
                    help="the full clinical coronary (the port's routes)")
    args = ap.parse_args()
    out = args.out or tempfile.mkdtemp(prefix="flux_balance_")
    os.makedirs(out, exist_ok=True)
    print(f"coronary {_spec_kw(args.period, args.full)}; one period of "
          f"{args.period} steps; fluxes in lattice cells^3/step; the port "
          f"on {args.device}")
    for route in args.routes.split(","):
        t0 = time.perf_counter()
        if route in ("xla", "sparse"):
            if args.full:
                raise SystemExit("--full runs the port's routes only")
            spec, log = run_lbm_tpu(route, args.period)
            name = f"lbm_tpu {route}"
        else:
            spec, log = run_port(route.replace("torch_", ""), args.period,
                                 args.device, args.full)
            name = f"lbm_tpu_torch {route.replace('torch_', '')}"
        nb = len(spec.boundaries)
        hdr = ",".join(["step"] + [f"flux_bc{b}" for b in range(nb)]
                       + ["fluid_mass"])
        path = os.path.join(out, f"flux_{route}.csv")
        np.savetxt(path, log, delimiter=",", header=hdr, comments="",
                   fmt="%.9g")
        b = _balance(spec, log)
        print(f"{name}: in {b['mean_in']:.6f}, out "
              + " ".join(f"{v:.6f}" for v in b["mean_out_each"])
              + f" (sum {b['mean_out']:.6f}), net in {b['mean_net']:.6f}, "
              f"mass change {b['mean_dmass']:.6f} a step "
              f"(mass {b['mass0']:.3f} -> {b['mass_end']:.3f}), "
              f"unaccounted {b['unaccounted']:.6f} a step; "
              f"{time.perf_counter() - t0:.1f} s -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
