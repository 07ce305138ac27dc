"""Command-line runner (torch port of lbm_tpu/cli.py's `run` and `list`):

    python -m lbm_tpu_torch run --case lid_driven_cavity --out out/
    python -m lbm_tpu_torch run --case poiseuille --steps 4400 --device cuda
    python -m lbm_tpu_torch run --case lid_driven_cavity --resume out/lid_driven_cavity.ckpt.npz
    python -m lbm_tpu_torch run --case coronary \
        --opt shape=[291,291,372] radius=12 pulsatile=[40,2000]
    python -m lbm_tpu_torch run --case gravity_channel --opt collision=trt
    python -m lbm_tpu_torch run --case coronary --opt collision=trt \
        'rheology={"model": "carreau", "nu0": 0.3145, "nu_inf": 0.01937, "lam": 149036, "n": 0.3568}'
    python -m lbm_tpu_torch run --case gravity_channel --backend dense \
        --opt collision=mrt
    python -m lbm_tpu_torch list

--opt values are read as JSON where they parse (lists, numbers, dicts)
and as strings otherwise; the rheology dict above is
core/rheology.carreau_blood at the coronary's units. --backend dense runs the dense PyTorch step,
which takes the compositions the kernels refuse (MRT or a tau closure
with a body force).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_kv(pairs: list[str]) -> dict:
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lbm_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a case")
    runp.add_argument("--case", required=True)
    runp.add_argument("--out", default="out")
    runp.add_argument("--steps", type=int, default=None)
    runp.add_argument("--time-save", type=int, default=None)
    runp.add_argument("--checkpoint-every", type=int, default=0,
                      help="save a resumable checkpoint every N saves")
    runp.add_argument("--resume", default=None, help="checkpoint to resume")
    runp.add_argument("--no-vtk", action="store_true")
    runp.add_argument("--vtk-final", action="store_true",
                      help="write VTK only once, after the run finishes")
    runp.add_argument("--binary-vtk", action="store_true")
    runp.add_argument("--opt", nargs="*", metavar="KEY=VAL",
                      help="case options (e.g. n=128 tau=0.55)")
    runp.add_argument("--device", default="cuda",
                      help="torch device: cuda runs the CUDA kernels, cpu "
                      "their plain PyTorch versions")
    runp.add_argument("--backend", default="kernel",
                      choices=("kernel", "dense"),
                      help="kernel: the collide-stream kernels (their plain "
                      "versions on the CPU); dense: the dense PyTorch step")

    sub.add_parser("list", help="list available cases")

    args = parser.parse_args(argv)

    if args.cmd == "list":
        from lbm_tpu_torch.cases import list_cases

        for name in list_cases():
            print(name)
        return 0

    import numpy as np

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine import checkpoint as ckpt
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.io.convlog import ConvergenceLog
    from lbm_tpu_torch.io.vtk import case_vtk

    spec = get_case(args.case, **_parse_kv(args.opt))
    sim = Simulation(spec, device=args.device, backend=args.backend)
    if args.resume:
        ckpt.restore(sim, args.resume)
        print(f"resumed from {args.resume} at step {sim.t}")

    os.makedirs(args.out, exist_ok=True)
    log = ConvergenceLog(args.out)
    t0 = time.perf_counter()
    save_count = 0

    def on_save(sim, k, residual):
        nonlocal save_count
        save_count += 1
        log.residual(residual)
        if not args.no_vtk and not args.vtk_final:
            case_vtk(sim, args.out, k, include_density=spec.vtk_density,
                     binary=args.binary_vtk)
        if args.checkpoint_every and save_count % args.checkpoint_every == 0:
            ckpt.save_sim(
                os.path.join(args.out, f"{spec.name}.ckpt.npz"), sim
            )

    result = sim.run(
        max_steps=args.steps, time_save=args.time_save, on_save=on_save
    )
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    nlattice = int((np.asarray(spec.mask) != 0).sum())
    print(
        f"TOTAL RUNNING TIME: {elapsed_ms:.1f} MILLI SECONDS "
        f"#LATTICE {nlattice}  {result.mlups:.1f} MLUPS ({sim.device})"
    )
    print(f"Residual is {result.residual:g}")
    log.finish(elapsed_ms, nlattice, result.residual)
    if not args.no_vtk:
        case_vtk(sim, args.out, sim.t, include_density=spec.vtk_density,
                 binary=args.binary_vtk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
