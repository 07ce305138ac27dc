"""Command-line runner (torch port of lbm_tpu/cli.py's `run`, `list`,
`transport` and `thermal`):

    python -m lbm_tpu_torch run --case lid_driven_cavity --out out/
    python -m lbm_tpu_torch run --case poiseuille --steps 4400 --device cuda
    python -m lbm_tpu_torch run --case lid_driven_cavity --resume out/lid_driven_cavity.ckpt.npz
    python -m lbm_tpu_torch run --case coronary \
        --opt shape=[291,291,372] radius=12 pulsatile=[40,2000]
    python -m lbm_tpu_torch run --case gravity_channel --opt collision=trt
    python -m lbm_tpu_torch run --case coronary --wss --wss-stats \
        --opt shape=[291,291,372] radius=12 pulsatile=[40,2000] \
        'windkessel=[[2e-4,2e4,1e-3],[2e-4,2e4,3e-3],[2e-4,2e4,3e-3],[2e-4,2e4,3e-3]]'
    python -m lbm_tpu_torch run --case coronary --opt collision=trt \
        'rheology={"model": "carreau", "nu0": 0.3145, "nu_inf": 0.01937, "lam": 149036, "n": 0.3568}'
    python -m lbm_tpu_torch run --case gravity_channel --backend dense \
        --opt collision=mrt
    python -m lbm_tpu_torch run --case lid_driven_cavity --fuse 2
    python -m lbm_tpu_torch run --case lid_driven_cavity --opt n=512 --lowmem
    python -m lbm_tpu_torch run --case lid_driven_cavity --dtype bf16
    python -m lbm_tpu_torch run --case lid_driven_cavity --shard 4
    python -m lbm_tpu_torch run --device cpu --case coronary --shard 2 \
        --opt shape=[48,32,40] radius=5
    python -m lbm_tpu_torch run --case pipe --backend dense
    python -m lbm_tpu_torch run --case bifurcation --snapshots \
        --opt geo_path=/path/geo.txt bc_path=/path/bc.txt
    python -m lbm_tpu_torch run --case coronary --opt curved=true \
        --backend sparse --snapshots --profile out/trace
    python -m lbm_tpu_torch list
    python -m lbm_tpu_torch transport --case coronary --bolus 500 --vtk \
        --opt shape=[291,291,372] radius=12
    python -m lbm_tpu_torch transport --case coronary --coupled \
        --opt pulsatile=[40,2000]
    python -m lbm_tpu_torch thermal --thermal-case cavity3d --n 32

`transport` converges the flow (--flow-steps), then runs the scalar on
the frozen velocity (or, with --coupled, flow and scalar together) and
writes <case>_washout.csv: one row a step, one column a boundary, the
mean concentration on each boundary's consumer plane. `thermal` runs a
Boussinesq case of cases/thermal.py in --chunks runs of --steps and
prints the Nusselt number after each. Both take the kernel route on a
CUDA device and the plain versions with --device cpu, for every case;
--backend dense runs the dense PyTorch route.

`run --shard N` splits the box along its first axis without a boundary
plane over N ranks it starts itself (spawned processes, one
torch.distributed group): with --device cuda one card a rank over NCCL
(N above the machine's card count is refused), with --device cpu over
gloo. Rank 0 alone prints and writes the VTK files, CONVERGENCE.log and
checkpoints.

A run with windkessel (RCR) outlets (--opt windkessel=..., one (Rp, C,
Rd) lattice triple an outlet) prints their P_c in mmHg at the end. --wss
adds the wall shear stress (Pa) to every VTK file; --wss-stats samples
the wall traction at every save and writes TAWSS (Pa) and OSI into the
final one (engine/stress.py).

--backend sparse steps the live cells only (engine/sparse.py, lbm_tpu's
'sparse'); it and --backend dense run Bouzidi curved walls (pipe, and
coronary with curved=true), which the kernel backend
refuses in lbm_tpu's words. --snapshots writes the reference's
auxiliary files after the run (meas1.txt, s1_out.txt, vel.csv;
io/snapshots.py); --profile DIR traces sim.run with torch.profiler into
DIR/trace.json (utils/profiling.trace; rank 0 alone under --shard).

--opt values are read as JSON where they parse (lists, numbers, dicts)
and as strings otherwise; the rheology dict above is
core/rheology.carreau_blood at the coronary's units. --backend dense runs the dense PyTorch step,
which takes the compositions the kernels refuse (MRT or a tau closure
with a body force).
"""

from __future__ import annotations

import argparse
import contextlib
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


def _cmd_transport(args) -> int:
    import numpy as np

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.scalar import CoupledTransport, ScalarTransport
    from lbm_tpu_torch.io.vtk import write_structured_points

    spec = get_case(args.case, **_parse_kv(args.opt))
    rec = list(range(len(spec.boundaries)))
    inlet_c = {args.inlet: 1.0}
    if args.bolus:
        gate = int(args.bolus)
        inlet_c = {args.inlet: lambda t: 1.0 if t < gate else 0.0}
    t0 = time.perf_counter()
    if args.coupled:
        tr = CoupledTransport(spec, D=args.D, inlet_c=inlet_c, div_fix=False,
                              device=args.device, backend=args.backend)
        kind = f"coupled ({args.backend} route)"
    else:
        from lbm_tpu_torch.engine.runner import Simulation

        sim = Simulation(spec, device=args.device, backend=args.backend)
        sim.run(max_steps=args.flow_steps,
                time_save=min(1000, args.flow_steps), verbose=False)
        tr = ScalarTransport(spec, sim.macro()[1], D=args.D, inlet_c=inlet_c,
                             device=args.device, backend=args.backend)
        del sim
        kind = (f"frozen-field ({args.backend} route) after "
                f"{args.flow_steps} flow steps")
    print(f"transport: {kind} on {tr.sc.device}, D={args.D}, horizon "
          f"{args.steps}")
    series = tr.run(args.steps, record=rec)
    dt = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{spec.name}_washout.csv")
    hdr = ",".join(f"bc{k}" for k in rec)
    np.savetxt(path, series, delimiter=",", header="step," + hdr,
               comments="", fmt="%.6e")
    print(f"washout series -> {path} ({args.steps} steps, {dt:.1f}s total "
          "incl. flow)")
    for k in rec:
        print(f"  bc{k}: peak {series[:, k].max():.4f} at step "
              f"{int(series[:, k].argmax())}, final {series[-1, k]:.5f}")
    if args.vtk:
        vp = os.path.join(args.out, f"{spec.name}_c_{args.steps}.vtk")
        write_structured_points(
            vp, {"CONCENTRATION": tr.concentration().cpu().numpy()},
            spacing=spec.units.CH, origin=(0.0, 0.0, 0.0), binary=True)
        print(f"concentration field -> {vp}")
    return 0


def _cmd_thermal(args) -> int:
    import numpy as np

    from lbm_tpu_torch.cases import thermal as tcases
    from lbm_tpu_torch.engine.thermal import BuoyantTransport
    from lbm_tpu_torch.io.vtk import write_structured_points

    if args.thermal_case == "cavity":
        spec, kwargs, info = tcases.heated_cavity(
            n=args.n, ra=args.ra, pr=args.pr, tau=args.tau)
        hot_axis = 0
    elif args.thermal_case == "rb":
        spec, kwargs, info = tcases.rayleigh_benard(
            nx=2 * args.n, nz=args.n, ra=args.ra, pr=args.pr, tau=args.tau)
        hot_axis = 2
    elif args.thermal_case == "cavity3d":
        spec, kwargs, info = tcases.heated_cavity_3d(
            n=args.n, ra=args.ra, pr=args.pr, tau=args.tau)
        hot_axis = 0
    else:
        nz = args.nz or (args.n // 2 + 2)
        spec, kwargs, info = tcases.rayleigh_benard_3d(
            nx=args.n, ny=args.n, nz=nz, ra=args.ra, pr=args.pr,
            tau=args.tau)
        hot_axis = 2
    bt = BuoyantTransport(spec, device=args.device, backend=args.backend,
                          **kwargs)
    print(f"thermal: {spec.name} {spec.shape} Ra={args.ra:g} Pr={args.pr} "
          f"({args.backend} route on {bt.sc.device})")
    t0 = time.perf_counter()
    for k in range(args.chunks):
        bt.run(args.steps)
        planes, nu = bt.nusselt_profile(hot_axis, info["kappa"], info["dT"],
                                        info["H"])
        print(f"chunk {k}: t={bt.t}  Nu={float(np.mean(nu)):.4f} "
              f"(spread {np.ptp(nu):.4f})", flush=True)
    dt = time.perf_counter() - t0
    print(f"{args.chunks * args.steps} steps in {dt:.1f}s = "
          f"{dt / (args.chunks * args.steps) * 1e3:.3f} ms/step")
    if args.vtk:
        os.makedirs(args.out, exist_ok=True)
        vp = os.path.join(args.out, f"{spec.name}_{bt.t}.vtk")
        write_structured_points(
            vp, {"TEMPERATURE": bt.concentration().cpu().numpy(),
                 "VELOCITY": bt.macro()[1].cpu().numpy()},
            spacing=spec.units.CH, origin=(0.0, 0.0, 0.0), binary=True)
        print(f"fields -> {vp}")
    return 0


def _add_device_args(p, backends=("kernel", "dense")) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu "
                   "their plain PyTorch versions")
    p.add_argument("--backend", default="kernel", choices=backends,
                   help="kernel: the CUDA kernels (their plain versions on "
                   "the CPU); dense: the dense PyTorch route"
                   + ("; sparse: the live-cell PyTorch route"
                      if "sparse" in backends else ""))


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
    runp.add_argument("--wss", action="store_true",
                      help="add the wall shear stress field (Pa) to the VTK "
                      "outputs (engine/stress.py)")
    runp.add_argument("--wss-stats", action="store_true",
                      help="accumulate TAWSS (Pa) and OSI over the run, "
                      "sampled at every save (for pulsatile cases make "
                      "--time-save divide the period), into the final VTK")
    runp.add_argument("--opt", nargs="*", metavar="KEY=VAL",
                      help="case options (e.g. n=128 tau=0.55)")
    runp.add_argument("--fuse", type=int, default=1, choices=[1, 2],
                      help="fused steps per HBM round-trip (kernel backend; "
                      "fuse=2 needs all BCs on x/y planes)")
    runp.add_argument("--lowmem", action="store_true",
                      help="force the 512^3-class lowmem machinery (chunked "
                      "state read to the host, uncompressed checkpoints; "
                      "auto-enabled above ~4 GB of state)")
    runp.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                      help="pdf STORAGE dtype on the kernel backend "
                      "(compute stays fp32; bf16 halves the state's bytes)")
    runp.add_argument("--shard", type=int, default=0,
                      help="split the lattice over N ranks (0: one device; "
                      "cuda: one card a rank over NCCL, cpu: gloo)")
    runp.add_argument("--snapshots", action="store_true",
                      help="write the reference's midplane/boundary snapshot "
                      "files (meas1.txt, s1_out.txt, vel.csv) after the run")
    runp.add_argument("--profile", default=None, metavar="DIR",
                      help="trace sim.run with torch.profiler into "
                      "DIR/trace.json")
    _add_device_args(runp, ("kernel", "dense", "sparse"))

    sub.add_parser("list", help="list available cases")

    trp = sub.add_parser(
        "transport",
        help="contrast washout on a case: converge the flow, then run the "
        "scalar on the frozen field (or --coupled: flow and scalar "
        "together)")
    trp.add_argument("--case", required=True)
    trp.add_argument("--opt", nargs="*", metavar="KEY=VAL", default=[])
    trp.add_argument("--out", default="out")
    trp.add_argument("--D", type=float, default=0.02,
                     help="lattice diffusivity")
    trp.add_argument("--flow-steps", type=int, default=2000,
                     help="flow steps before the transport (frozen route)")
    trp.add_argument("--steps", type=int, default=4000)
    trp.add_argument("--bolus", type=int, default=0,
                     help="inlet c=1 gate length in steps (0 = steady inlet "
                     "c=1)")
    trp.add_argument("--inlet", type=int, default=0,
                     help="inlet boundary index")
    trp.add_argument("--coupled", action="store_true",
                     help="time-resolved: flow and scalar advance together "
                     "(pulsatile cases)")
    trp.add_argument("--vtk", action="store_true",
                     help="write the final concentration field")
    _add_device_args(trp)

    thp = sub.add_parser(
        "thermal",
        help="Boussinesq natural convection (cases/thermal.py): heated "
        "cavity / Rayleigh-Benard")
    thp.add_argument("--thermal-case", default="cavity3d",
                     choices=["cavity", "rb", "cavity3d", "rb3d"])
    thp.add_argument("--n", type=int, default=32)
    thp.add_argument("--nz", type=int, default=None)
    thp.add_argument("--ra", type=float, default=1e4)
    thp.add_argument("--pr", type=float, default=0.71)
    thp.add_argument("--tau", type=float, default=0.66)
    thp.add_argument("--steps", type=int, default=5000)
    thp.add_argument("--chunks", type=int, default=4)
    thp.add_argument("--out", default="out")
    thp.add_argument("--vtk", action="store_true")
    _add_device_args(thp)

    args = parser.parse_args(argv)

    if args.cmd == "transport":
        return _cmd_transport(args)
    if args.cmd == "thermal":
        return _cmd_thermal(args)

    if args.cmd == "list":
        from lbm_tpu_torch.cases import list_cases

        for name in list_cases():
            print(name)
        return 0

    if args.shard:
        return _run_sharded(args)
    return _run(None, args)


def _run_sharded(args) -> int:
    """`run --shard N`: N spawned ranks, NCCL one card each or gloo on
    the CPU."""
    import torch

    from lbm_tpu_torch.parallel.launch import spawn

    n = args.shard
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda was requested but "
                               "torch.cuda.is_available() is False; pass "
                               "--device cpu to shard over gloo")
        cards = torch.cuda.device_count()
        if n > cards:
            raise SystemExit(f"--shard {n} runs one rank a card over NCCL, "
                             f"and this machine has {cards} card(s)")
        backend = "nccl"
    else:
        backend = "gloo"
    spawn(_run, n, (args,), backend=backend, device=args.device)
    return 0


def _run(mesh, args) -> int:
    """The `run` command on one device (mesh None), or as one rank of
    `mesh` (every rank steps and gathers; rank 0 prints and writes)."""
    import numpy as np

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine import checkpoint as ckpt
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.io.convlog import ConvergenceLog
    from lbm_tpu_torch.io.vtk import case_vtk

    lead = mesh is None or mesh.rank == 0
    spec = get_case(args.case, **_parse_kv(args.opt))
    sim = Simulation(spec, device=args.device, backend=args.backend,
                     fuse=args.fuse, lowmem=True if args.lowmem else None,
                     store_dtype=args.dtype, mesh=mesh)
    if args.resume:
        ckpt.restore(sim, args.resume)
        if lead:
            print(f"resumed from {args.resume} at step {sim.t}")
    if mesh is not None and lead:
        print(f"sharded over {mesh.world} ranks ({mesh.backend}) along axis "
              f"{sim.shard_axis}")

    if lead:
        os.makedirs(args.out, exist_ok=True)
        log = ConvergenceLog(args.out)
    t0 = time.perf_counter()
    save_count = 0
    wss_acc = None

    def vtk(k, extra=None):
        if lead:
            case_vtk(sim, args.out, k, include_density=spec.vtk_density,
                     binary=args.binary_vtk, include_wss=args.wss,
                     extra_fields=extra)
        else:
            sim.macro()  # the gather every rank takes part in
            if args.wss:
                sim.wss()

    def on_save(sim, k, residual):
        nonlocal save_count, wss_acc
        save_count += 1
        if lead:
            log.residual(residual)
        if args.wss_stats:
            if wss_acc is None:
                wss_acc = sim.wss_accumulator()
            wss_acc.sample_sim(sim)
        if not args.no_vtk and not args.vtk_final:
            vtk(k)
        if args.checkpoint_every and save_count % args.checkpoint_every == 0:
            ckpt.save_sim(
                os.path.join(args.out, f"{spec.name}.ckpt.npz"), sim
            )

    tracing = contextlib.nullcontext()
    if args.profile and lead:
        from lbm_tpu_torch.utils.profiling import trace

        tracing = trace(args.profile)
    with tracing:
        result = sim.run(
            max_steps=args.steps, time_save=args.time_save, on_save=on_save,
            verbose=lead,
        )
    if args.profile and lead:
        print(f"profile -> {os.path.join(args.profile, 'trace.json')}")
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    nlattice = int((np.asarray(spec.mask) != 0).sum())
    if lead:
        print(
            f"TOTAL RUNNING TIME: {elapsed_ms:.1f} MILLI SECONDS "
            f"#LATTICE {nlattice}  {result.mlups:.1f} MLUPS ({sim.device})"
        )
        print(f"Residual is {result.residual:g}")
        if sim.wk is not None:
            from lbm_tpu_torch.engine.diagnostics import MMHG_PER_PA

            pc = sim.wk.cpu().numpy() * spec.units.C_pre * MMHG_PER_PA
            print("Windkessel P_c (mmHg gauge): "
                  + " ".join(f"{v:.4f}" for v in pc))
        log.finish(elapsed_ms, nlattice, result.residual)
    if not args.no_vtk:
        extra = None
        if wss_acc is not None and wss_acc.n_samples:
            extra = {"TAWSS": wss_acc.tawss_field().cpu().numpy()
                     * spec.units.C_pre,
                     "OSI": wss_acc.osi_field().cpu().numpy()}
        vtk(sim.t, extra)
    if args.snapshots:
        from lbm_tpu_torch.io.snapshots import (
            write_bc_csv,
            write_midplane,
            write_midplane_fluid,
        )

        u = sim.macro()[1]  # every rank takes part in the gather
        if lead:
            u = u.cpu().numpy()
            write_midplane(os.path.join(args.out, "meas1.txt"), u)
            write_midplane_fluid(os.path.join(args.out, "s1_out.txt"), u,
                                 spec.mask)
            write_bc_csv(os.path.join(args.out, "vel.csv"), u, spec.mask)
    return 0


if __name__ == "__main__":
    sys.exit(main())
