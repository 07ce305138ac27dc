"""The clinical coronary step's cost, one mechanism a row (the port of
lbm_tpu's tools/profile_clinical.py): the 291x291x372 synthetic tree at
increasing composition levels, each row timed on the kernel route.

  flow          BGK, prescribed outlets: the list K1 [bgk] over the
                fluid cells, its three z outlets in the same launch
  flow+wksub    + RCR on the three z sub-outlets, the x outlet
                prescribed: the fold [bgk+wk] (K1 with the outlets' flux
                folded in, its reduction committing P_c)
  flow+wk       + RCR on the main x outlet (the fold's x plane too)
  flow+wk+pulse + the series inlet (inside the same launch)
  coupled       CoupledTransport, no windkessel: K1 then K8 over the
                scalar's cell list and the record
  clinical      everything: the fold, the series inlet and K8

Each row is one warm run of --steps and then a timed run of the same
length, which ends in a device read (the runner's velsum series, the
transport's record). The tree is built once (cases/coronary.py keeps the
last geometry); each row compiles its own case.

Usage: python -m lbm_tpu_torch.tools.profile_clinical
         [--shape 291,291,372] [--radius 10] [--steps 300]
         [--only flow,clinical] [--device cuda]
Smoke: --shape 48,24,40 --radius 5 --steps 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from lbm_tpu_torch.tools import device_label

WK = [(2e-4, 2e4, 1e-3)] + [(2e-4, 2e4, 3e-3)] * 3
ROWS = ("flow", "flow+wksub", "flow+wk", "flow+wk+pulse", "coupled",
        "clinical")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="291,291,372")
    ap.add_argument("--radius", type=int, default=10)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--only", default=None,
                    help="comma list of row names to run")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    return ap.parse_args(argv)


def row_spec(name: str, shape, radius: int):
    """(kind, spec) of a row: kind 'flow' (Simulation) or 'coupled'
    (CoupledTransport)."""
    from lbm_tpu_torch.cases import get_case

    kw = dict(shape=shape, radius=radius)
    if name in ("flow+wk", "flow+wksub"):
        kw["windkessel"] = WK
    if name in ("flow+wk+pulse", "clinical"):
        kw.update(windkessel=WK, pulsatile=(40, 2000))
    spec = get_case("coronary", **kw)
    if name == "flow+wksub":
        bcs = list(spec.boundaries)
        bcs[1] = dataclasses.replace(bcs[1], windkessel=None)
        spec = dataclasses.replace(spec, boundaries=bcs)
    return ("coupled" if name in ("coupled", "clinical") else "flow"), spec


def make_row(kind: str, spec, device):
    """(the row's Simulation or CoupledTransport, run(n): n steps of it
    ending in a device read)."""
    if kind == "flow":
        from lbm_tpu_torch.engine.runner import Simulation

        sim = Simulation(spec, device=device, backend="kernel")
        return sim, lambda n: sim.run(max_steps=n, time_save=n,
                                      verbose=False)
    from lbm_tpu_torch.engine.scalar import CoupledTransport

    ct = CoupledTransport(spec, tau_g=0.6, inlet_c={0: 1.0}, device=device,
                          backend="kernel")
    return ct, lambda n: ct.run(n, record=[0, 1])


def time_row(run, steps: int) -> float:
    """ms a step of run(steps) after one warm run of the same length."""
    run(steps)
    t0 = time.perf_counter()
    run(steps)
    return (time.perf_counter() - t0) / steps * 1e3


def main(argv=None) -> dict:
    args = parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split(","))
    only = set(args.only.split(",")) if args.only else set(ROWS)
    print(f"device: {device_label(args.device)}; coronary {shape} radius="
          f"{args.radius}, {args.steps} steps a run", flush=True)
    out, prev = {}, None
    for name in ROWS:
        if name not in only:
            continue
        t0 = time.perf_counter()
        kind, spec = row_spec(name, shape, args.radius)
        _, run = make_row(kind, spec, args.device)
        ms = time_row(run, args.steps)
        total = time.perf_counter() - t0
        note = "" if prev is None else f" (delta {ms - prev:+.2f})"
        print(f"{name:<14} {ms:6.2f} ms/step{note}  "
              f"[total incl. set-up {total:.0f}s]", flush=True)
        out[name] = {"ms": ms, "total_s": total}
        prev = ms
    return out


if __name__ == "__main__":
    main()
